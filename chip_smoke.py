"""On-card smoke run of the PyTorch/H100 port (`elasticdl_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero on any failure and prints
its result lines only when every phase passed:

1. the card's name and power limit (`nvidia-smi`);
2. builds the attention kernels from `elasticdl_tpu_torch/ops/csrc/`,
   prints ptxas's register, shared-memory and spill lines, and fails if
   an instantiation of a kernel (`NO_SPILL`: the tensor-core ones and the
   three float32 ones) spills or is missing at a head dim (16, 32, 64,
   128);
3. holds each kernel against its plain PyTorch version on the card at
   every head dim (`KERNEL_CHECKS`): in bfloat16 at the base
   transformer's [8, 1024, 8, 64], the large config's [16, 1024, 8, 128]
   and the zoo default's [8, 1024, 4, 16] for three input seeds, at the
   reference kernel test's [2, 256, 2, 32], and at the shapes the D = 16
   and 32 kernels are timed at; in float32 at a small shape and at the
   zoo default's (its main path's kernels, also timed there); and at
   [1, 192, 3, D] (L a multiple of 64 but not of 128, B*H odd) in both
   dtypes, causal and not, under a limit per output (bf16 gradients may
   also differ by two rounding flips of a row's largest term,
   `exact_backward`, and must be as close to the float64 function in
   root mean square as the plain version, `BF16_RMS_RATIO`); each
   backward check runs once on the plain forward's lse and once on the
   kernel's own lse and o. Times kernel, plain version and the library
   yardsticks at each head dim's timed shape (at 16 and 32 the base's
   tokens and width in heads of 16 and 32), which the port never calls:
   `F.scaled_dot_product_attention` for the forward, and one call of
   aten's flash-attention backward (dq, dk and dv together, checked
   against the plain versions) for the backward pair; each kernel's
   bound is the largest of three terms (`bounds`: the products on the
   tensor cores, the bytes, the exponentials on the special-function
   units at the card's SM clock). Then checks the model's forward and
   backward against the materializing reference, and the MoE model's
   (`phase_moe_reference`: dense dispatch at a capacity that drops
   nothing) against the per-token reference loop;
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
   (device, accepted steps, each kernel launched n_layers times per step
   computed, no fallback); then the same job of the zoo's default model
   with no `--model_params` (float32, the kernels at D = 16);
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
   run gives the device idle share; then the local-steps ladder with the
   adaptive wire plane (`phase_window_ladder_adaptive`: W 4, 2 windows a
   push, `sync_adaptive="on"`, 32 steps in tasks of 8): the exactness
   block, 4 pushes of 8 steps each under one key, the decision log (a
   bf16 cold start), every push's wire bytes at most the float32
   delta's, the launches; prints the decisions and the bytes by form;
8. error feedback on the card (`phase_ef_card`) over a delta of the
   model's size: the int8 quantizer bit for bit with
   `codec.quantize_int8`, the bf16 cast bit for bit, top-k indices,
   values and residual equal to the CPU's; prints each one's ms;
9. the zoo's default model (`custom_model()`: d_model 64, 4 heads of 16,
   2 layers) over b8 x s1024 records (`phase_zoo_default`): 8 per-step
   updates in float32 as a user gets it (the CUDA-core kernels at D =
   16), 8 with `dtype=bfloat16` (the tensor-core kernels), 16 window
   steps in bf16, each with the exactness block, steps computed =
   applied, finite losses, moved parameters, 0 fallbacks and the
   launches (each kernel n_layers times a step at D = 16, 0 elsewhere);
   its width with `n_heads=8` (head dim 8) trains one step through the
   dispatcher's fallback (`phase_zoo_head_dim8`); then the reference's
   large config (`phase_large`: d_model 1024, 8
   heads of 128, 16 layers, remat "dots", bf16, b16 x s1024, 218.1M
   parameters, built from its `--model_params` string): 4 per-step
   updates and 8 window steps in-process; checks the exactness block,
   steps computed = applied, finite losses, moved parameters, 0
   fallbacks and the launches (forward twice a layer a step: the remat
   recompute; dq and dk+dv once); prints steady tokens/s, the
   ReportGradient handler seconds, the window sync split, and the peak
   device memory of one step under remat off / full / dots; the
   reference's xl config (`phase_xl`: d_model 2048, 16 heads of 128, d_ff
   8192, 8 layers, remat "dots", bf16, b8 x s1024, 436,242,432
   parameters), 2 per-step updates and 8 window steps with the same
   checks and prints, and its peak memory of one step; the reference's
   MoE config (`phase_moe`: the base width with every FFN 8 experts of
   256, top-1 at capacity factor 2.0, bf16, b8 x s1024, 33,595,904
   parameters), 8 per-step updates and 16 window steps with the same
   checks, every leaf and in every layer the router and each expert's
   weights moved; then one `_route` call on a real batch (tokens per
   expert, dropped share, aux), the peak memory of one step and the
   step's device time split by torch.profiler into the routing products,
   the expert FFNs, attention and the rest;
10. window mode in process mode (`phase_window_process_job`): master.main
   with `--local_updates 4 --sync_dtype bfloat16`, 2 workers, 32 steps;
   checks rc, versions (the `--output` version = the workers' applied
   steps), steps computed = applied, finite moved parameters, each
   worker's device, launches and no fallback; prints merged-back absorbs
   and the background model page-in (pulls, staged models folded in)
   per worker, and rpc and PS add a sync (the servicer lock included);
   then the same of the large config (b16, tasks of one window, 8
   steps); then the sharded PS: the xl config as 2 worker processes over
   `--num_ps 4 --ps_mode process` (`phase_xl_sharded_processes`: W 4,
   bf16 EF, b8, 16 steps over shm, seeded from a version-0 init
   checkpoint of 1.75 GB through `--checkpoint_filename_for_init`, since
   xl's tree is over the 1 GiB frame) and the base transformer async
   per-step as 2 worker processes over `--num_ps 2 --ps_mode inproc`
   (`phase_sharded_async`: 16 updates, one checkpoint with each shard's
   optimizer state) at the reference's default per-step depth (4 reports
   in flight), then its `--step_pipeline 0` twin, with the two tokens/s
   side by side (an A/B within the call); each checks rc, every shard's version and the
   master's at init + the applied steps, steps accepted = computed, the
   launches, finite losses, moved parameters (xl: shm links, no shard
   process or segment left; async: the checkpoint's per-shard Adam
   counts), and prints tokens/s, each shard's apply and lock wait a
   push, and the workers' sync split; then the shard recovery plane
   (`phase_shard_failover`): the base transformer as 2 worker processes
   over 2 PS shard processes on shm (W 4, bf16 EF, 32 steps), PS shard
   1's process SIGKILLed from outside at its 3rd applied push: rc 0,
   recoveries [("ps", 1, 1)], generations [0, 1], nothing
   unrecoverable, a version-exact seed, each shard and the master at
   init + 32, 32 steps accepted, launches n_layers x steps computed, no
   fallback, finite losses; prints the recovery's seconds from the kill
   (detected, fenced, restore upload accepted, serving, the relaunched
   shard's first push), the relaunched process's boot and each worker's
   background pulls (through `ShardedPS.pull_async`) and staged models
   folded in; the run fails unless a 2-worker window phase paged a model
   in (`PAGE_IN`);
11. the drain (`phase_window_drain`): SIGTERM to worker 0 mid-window of
   the same job drains it (exit 0, its drain line, nothing requeued,
   every step applied once); SIGKILL in a second job requeues its tasks
   and the job finishes with no failed task and every step applied once
   (the replayed windows deduped by their report keys);
12. the image zoo (no attention: every image run checks 0 launches and 0
   fallbacks): `phase_image_models` holds one train-mode forward and
   backward of each image model (mnist_functional_api, mnist_subclass,
   cifar10_functional_api, cifar10_subclass, resnet50_subclass, and
   ResNet-50 in bf16) on the card against the same step on the CPU
   (`IMAGE_TOL`); `phase_image_per_step` trains cifar10 (b128, 64
   updates) and mnist (b64, 32) per-step, printing images/s and the host
   PS apply; `phase_cifar_window` runs the reference's headline job
   (`bench.py:360-432`: cifar10_functional_api in window mode, W 32,
   b128, 65,536 records in tasks of 4,096, bf16 EF deltas) with the
   exactness block, the reference's gate (median of the last 3 task
   losses < 1.5), the PS's batch_stats moved and equal to the last
   synced window's, images/s, then the device idle share of a profiled
   run of 2 tasks; `phase_resnet_window` trains ResNet-50 in bf16 at 64
   px in window mode (`bench_resnet.py:123-160`: W 32, b128, 8,192
   records, bf16 transport) with images/s and its peak device memory;
   `phase_image_process_job` runs master.main with `--model_def
   cifar10_functional_api.custom_model`, 2 workers per-step: the
   exactness block and the batch stats back through each worker's
   GetModel frames;
13. evaluation during training on the kernels' path
   (`phase_eval_kernels`): the base transformer at full width in bf16
   and the zoo's default in float32, in-process per-step, 8 updates in 2
   epochs with an evaluation job every 4 versions over 2 tasks of 8
   records: jobs at versions 4 and 8; each evaluation minibatch
   (`torch.inference_mode()`) adds exactly n_layers flash_forward
   launches at the model's head dim and no dq or dk+dv launch, with 0
   fallbacks; each minibatch's perplexity = exp(cross entropy); the
   training report after an evaluation is accepted at the version the
   worker left; the v8 job's cross entropy equals the plain model's (the
   PS's v8 snapshot, `reference_attention` materialized on the card)
   within the bf16 output limit (float32: MODEL_TOL); the peak memory of
   an evaluation minibatch beside a training step's;
14. exact resume on the card (`phase_resume`, the reference's protocol):
   the zoo's default in float32, one worker, one task an epoch: 2 epochs
   uninterrupted (twice, for the card's run-to-run spread), 1 epoch +
   `save_latest_checkpoint` + 1 resumed epoch, and a control resumed with
   `opt_state` stripped; the resume lands at the uninterrupted version,
   bit-equal when the card repeats itself (else within 1e-6), the control
   at least 100 times farther;
15. `BASELINE.json`'s "cifar10_subclass, 4 async workers + 1 PS"
   (`phase_async_process_job`): master.main with 4 worker processes on
   the card, `--use_async --lr_staleness_modulation` (so 4 reports in
   flight a worker, each worker's depth checked), minibatch 128,
   16,384 records in tasks of 1,024 (128 updates), evaluation every 32
   versions over 2,048 records, checkpoints every 32 kept to 2, the JSONL
   metrics sink: rc 0, `--output` at v128 = the workers' accepted steps,
   the exactness block, 0 attention launches, parameters and batch stats
   moved, each evaluation job over all 2,048 records, events.jsonl's
   eval and train-loss rows, exactly model_v96 and model_v128 with the
   optimizer's state, no eval snapshot left; prints images/s, the
   ReportGradient handler a step and the seconds per evaluation job;
   then (`phase_standalone_eval_predict`) master.main evaluating
   model_v128.ckpt with 2 workers (one job at v128, within 2/2,048 of the
   checkpoint's CPU forward and of the async job's own v128 evaluation
   when it made one), and an in-process prediction run of
   mnist_functional_api from a checkpoint (the processor's classes equal
   the CPU's away from near-ties);
16. the transport tiers (`phase_transport_probe`): one ResNet-50-sized
   ReportGradient (23.5M float32, 94.1 MB) and a model-sized response
   round trip between this process and a server process, 10 times after
   a warm-up, over tcp, uds, shm at the default 4 MiB ring (chunked) and
   shm with a whole-frame ring: median ms and GB/s, each link on the tier
   asked for, nothing left in /dev/shm or the socket directory. Phases
   16-18 share one short socket directory straight under the temp dir,
   since an AF_UNIX path holds at most 107 bytes;
17. `BASELINE.json`'s "imagenet_resnet50 -- 8 TPU workers, async PS"
   (`phase_imagenet_async`): 8 tars of 512 `<label>/<n>.npy` 64x64x3
   images converted by `data/recordio_gen/parallel_convert` with
   `models/imagenet_resnet50.py` into 8 shards (4,096 records), then
   master.main with 8 async worker processes on the card
   (`--use_async --lr_staleness_modulation`: 4 reports in flight a
   worker, b128, tasks of 512: 32 updates) over EDL_TRANSPORT=shm with a whole-frame ring: rc 0, the
   exactness block at v32 = the accepted steps, finite losses, moved
   parameters and batch statistics, every link on shm, 0 attention
   launches, no segment left; prints steady images/s, the
   ReportGradient handler a step, each worker's client seconds by
   method (codec, the rest), the peak memory of one worker, the CPUs;
18. `BASELINE.json`'s "resnet50_subclass elastic -- 50% worker churn" on
   `bench_elastic.py`'s protocol (`phase_resnet_churn`): 4 active worker
   processes and 1 warm standby, window mode (W 2, b64, tasks of 128),
   8,192 records x 2 epochs over shm; a stable run, then a churn run
   SIGKILLing half of the live active workers at 25%, 50% and 75% of the
   records; images/s of each from the first completed task, retention,
   relaunches, promotions, the warm ones among them, and each kill's
   seconds to the promoted standby's (and the other replacements') first
   accepted step; each run with no failed task, every minibatch applied
   once, no segment left after the workers (the killed ones' too), and
   in the churn run 3 waves, a promotion, at least one warm promotion
   and no more than the promotions, and every promoted standby that
   stood by pre-warmed;
19. `BASELINE.json`'s deepfm_edl_embedding, the sparse plane (no
   attention: every deepfm path must launch 0 attention kernels): builds
   the native embedding store (`master/embedding_cpp/embedding_store.cc`,
   g++) from the checkout; `phase_deepfm_models` holds one train step of
   each deepfm model (the elastic one and the in-model tables) on the
   card against the CPU (logits, dense gradient, BET gradients,
   DEEPFM_TOL); `phase_deepfm_per_step` trains deepfm_edl_embedding
   per-step in-process (b128, 4,096 records, vocab 10,000, 32 updates)
   and `phase_deepfm_window` runs `bench.py:553-590`'s sparse cell (W
   16, b128, 8,192 records, BET prefetch off, then on, then a profiled
   run for the device idle share): each with the exactness block, finite
   losses, the native store, one row per non-zero id seen in each table
   plus the Adam slot rows, and (per-step) the rows moved from their
   lazy init; prints records/s, the phase split, the master's sparse
   apply and the sync split with the edl_gradient bytes;
   `phase_deepfm_kv_process` runs master.main with 2 KV shard processes
   and 2 worker processes over shm (W 16, 8,192 records from a vocab of
   1,000,000, one evaluation with AUC, one checkpoint with the tables),
   KV shard 1's process SIGKILLed at a quarter of the steps and restored
   from its ring pair: rc 0, recoveries [("kv", 1, 1)], 0
   EmbeddingLookup on the master, every link's tier, the shards' rows
   (at most the rows not restored lost), no shard process or segment
   left;
20. prints the kernels' JSON line (one row per kernel and head dim in
   bf16, 12 rows, plus the float32 kernels' own rows at the zoo
   default's [8, 1024, 4, 16], `{kernel}_d16_f32`, bound by products at
   the CUDA cores' float32 peak; the backward pair's yardstick once per
   head dim, as `backward_pair`, since no single kernel's row matches it;
   each wrapper counts its launches by head dim, and each row carries its
   own kernel's count at its own head dim in each path of its dtype:
   `launches` the row's main path (`MAIN_PATH`: the zoo default's
   per-step run in float32 for the f32 rows and in bf16 at 16, the base
   per-step run at 64, the large per-step run at 128; at 32, which no
   path runs, every path's count summed), `process_launches`,
   `window_launches`, `window_process_launches`, `large_launches`,
   `large_window_launches`, `large_window_process_launches`,
   `xl_launches`, `xl_window_launches`, `xl_sharded_process_launches`,
   `sharded_async_launches`, `sharded_async_depth0_launches`,
   `shard_failover_launches`, `ladder_adaptive_launches`, `moe_launches`,
   `moe_window_launches`, `zoo_bf16_launches`, `zoo_window_launches`
   (bf16 rows), `zoo_launches`, `zoo_process_launches` (float32 rows),
   and `eval_launches` on every row (phase 13's evaluation forward:
   n_layers x evaluation minibatches on the forward rows at the run's
   head dim and dtype, 0 elsewhere), and `deepfm_launches`,
   `deepfm_window_launches`, `deepfm_kv_process_launches` (0) on every row;
   and each row's bound term, `bound_term`, with all three terms), the
   card line, and the result line. Each phase prints its wall-clock
   seconds (`timed`).

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
import threading
import time
from concurrent.futures import ThreadPoolExecutor

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
# cores, float32 outside the tensor cores (the CUDA cores the f32 kernels
# run on) and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# exp2 results a clock per SM on the special-function units (Hopper: 16);
# times the SMs and the SM clock, the card's rate of exponentials
SFU_PER_SM_CLOCK = 16

SLICE = dict(vocab=8192, d_model=512, n_heads=8, d_ff=2048, n_layers=8)
SLICE_PARAMS = ",".join(f"{k}={v}" for k, v in SLICE.items()) + ",dtype=bfloat16"
BATCH, SEQ, STEPS = 8, 1024, 8
# the reference's large config (bench_transformer.py:172-186): 8 heads of
# 128, remat "dots", bf16 compute, b16 x s1024; its --model_params string
LARGE = dict(vocab=8192, d_model=1024, n_heads=8, d_ff=4096, n_layers=16)
LARGE_PARAMS = ("vocab=8192,d_model=1024,n_heads=8,d_ff=4096,n_layers=16,n_micro=1,"
                "dtype=bfloat16,remat=True,remat_policy=dots")
# (window steps cut from 16: the large window process phase trains it too)
LARGE_BATCH, LARGE_STEPS, LARGE_WINDOW_STEPS = 16, 2, 8
# the reference's xl config (bench_transformer.py:211-221): 16 heads of 128,
# d_ff 8192, 8 layers, remat "dots", bf16 compute, b8 x s1024
XL_PARAMS = ("vocab=8192,d_model=2048,n_heads=16,d_ff=8192,n_layers=8,n_micro=1,"
             "dtype=bfloat16,remat=True,remat_policy=dots")
XL_N_PARAMS = 436_242_432
# (cut from 4 and 16: phase_xl_sharded_processes trains xl 32 steps too)
XL_BATCH, XL_STEPS, XL_WINDOW_STEPS = 8, 2, 8
# the reference's MoE config (bench_transformer.py:245-257): the base
# transformer's width with every FFN 8 experts of d_expert 256 (top-1,
# capacity factor 2.0: the config's defaults), bf16 compute, b8 x s1024,
# the zoo's clip 1.0 + Adam
MOE_PARAMS = ("vocab=8192,d_model=512,n_heads=8,d_ff=2048,n_layers=8,n_experts=8,n_micro=1,"
              "dtype=bfloat16")
MOE_N_PARAMS = 33_595_904
MOE_STEPS, MOE_WINDOW_STEPS = 8, 16
# the zoo's default model, `custom_model()` with no --model_params (4 heads
# of 16), over records of SEQ tokens; ZOO_HEAD_DIM8 is its width with 8
# heads (head dim 8, which no kernel takes: the fallback on the card)
ZOO_DEFAULT = dict(vocab=128, d_model=64, n_heads=4, d_ff=128, n_layers=2)
ZOO_STEPS, ZOO_WINDOW_STEPS = 8, 16
# the base transformer's tokens and H*D = 512 cut into heads of 16 and 32:
# the shapes the D = 16 and 32 kernels are timed at
TIMED_16, TIMED_32 = (BATCH, SEQ, 32), (BATCH, SEQ, 16)
# window mode: W steps a sync, bf16 error-feedback deltas
WINDOW, WINDOW_STEPS = 4, 16
WINDOW_ARGS = ["--local_updates", str(WINDOW), "--sync_dtype", "bfloat16"]
# process mode: shards of 64 records, tasks of 32 (4 minibatches)
SHARD_RECORDS, TASK_RECORDS = 64, 32
ZOO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "elasticdl_tpu_torch", "models")
KERNELS = ("flash_forward", "flash_dq", "flash_dkv")
# each kernel row's main path, by (dtype, head dim) and its column in the
# kernels line: the zoo default's per-step run as a user gets it (float32,
# the CUDA-core kernels) and with dtype=bfloat16, the base per-step run,
# the large per-step run
MAIN_PATH = {("float32", 16): "zoo_launches", ("bfloat16", 16): "zoo_bf16_launches",
             ("bfloat16", 64): "launches", ("bfloat16", 128): "large_launches"}
# the paths that run the float32 kernels; every other path runs bf16
FLOAT32_PATHS = ("zoo_launches", "zoo_process_launches")
SOURCE = "elasticdl_tpu_torch/ops/csrc/flash_attention.cu"
# kernels that must not spill (ptxas's report): the tensor-core ones and
# the float32 ones
NO_SPILL = ("fa_fwd_bf16_kernel", "fa_dq_bf16_kernel", "fa_dkv_bf16_kernel",
            "fa_fwd_kernel", "fa_dq_kernel", "fa_dkv_kernel")
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


def bounds(b, L, h, d, causal=True, elem=2):
    """Per kernel: (least operations, least bytes, least exponentials).
    Operations are the matrix products' multiply-adds x2 over the visible
    (q, k) pairs; bytes read each input once and write each output once
    (tiles of `elem` bytes an element, f32 rows); exponentials are one exp2 per visible pair,
    and in the forward one more per row and 64-column k tile it visits
    (the running sum's correction). The other elementwise work is not
    counted."""
    pairs = b * h * (L * (L + 1) // 2 if causal else L * L)
    row_tiles = b * h * (sum(r // 64 + 1 for r in range(L)) if causal else L * (L // 64))
    tile = b * L * h * d * elem
    rows = b * h * L * 4
    return {
        "flash_forward": (2 * 2 * d * pairs, 3 * tile + tile + rows, pairs + row_tiles),
        "flash_dq": (3 * 2 * d * pairs, 4 * tile + 2 * rows + tile, pairs),
        "flash_dkv": (4 * 2 * d * pairs, 4 * tile + 2 * rows + 2 * tile, pairs),
    }


def bound_terms(ops, nbytes, exps, exp_per_s, flops=PEAK_BF16_FLOPS) -> dict:
    """The least time in ms of each term: the products at `flops` (the
    bf16 tensor cores', or PEAK_F32_FLOPS for the f32 kernels on the CUDA
    cores), the bytes over the memory rate, the exponentials over the
    card's special-function rate `exp_per_s`."""
    return {"products": ops / flops * 1e3, "bytes": nbytes / PEAK_BYTES * 1e3,
            "exp": exps / exp_per_s * 1e3}


def exp_rate() -> float:
    """exp2s a second: SMs x SFU_PER_SM_CLOCK x the card's top SM clock
    (`nvidia-smi --query-gpu=clocks.max.sm`, MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    mhz = float(out.stdout.strip().splitlines()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * SFU_PER_SM_CLOCK * mhz * 1e6


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
# check; the last of each head dim is the shape its kernels are timed at,
# on the first seed's inputs: at 64 and 128 the slice's shape, the base
# transformer's (8 heads of 64, b8 x s1024) and the large config's (8 of
# 128, b16 x s1024), at three seeds (the bf16 gradients' rounding flips
# vary with the inputs); at 16 and 32 the base's tokens and width cut
# into heads of 16 and 32 (TIMED_16, TIMED_32), after the zoo path's
# shape (4 heads of 16, b8 x s1024, in float32 as the zoo's default runs
# it and in bf16) and the reference kernel test's
# (tests/test_flash_attention.py: [2, 256, 2, 32])
KERNEL_CHECKS = (
    (torch.float32, (2, 256, 2), 16, (True,), (1,)),
    (torch.float32, (1, 192, 3), 16, (True, False), (1,)),
    (torch.bfloat16, (1, 192, 3), 16, (True, False), (1,)),
    (torch.float32, (BATCH, SEQ, ZOO_DEFAULT["n_heads"]), 16, (True,), (1,)),
    (torch.bfloat16, (BATCH, SEQ, ZOO_DEFAULT["n_heads"]), 16, (True,), (1, 2, 3)),
    (torch.bfloat16, TIMED_16, 16, (True,), (1,)),
    (torch.float32, (2, 256, 2), 32, (True,), (1,)),
    (torch.float32, (1, 192, 3), 32, (True, False), (1,)),
    (torch.bfloat16, (1, 192, 3), 32, (True, False), (1,)),
    (torch.bfloat16, (2, 256, 2), 32, (True, False), (1,)),
    (torch.bfloat16, TIMED_32, 32, (True,), (1,)),
    (torch.float32, (2, 256, 2), 64, (True,), (1,)),
    (torch.float32, (1, 192, 3), 64, (True, False), (1,)),
    (torch.bfloat16, (1, 192, 3), 64, (True, False), (1,)),
    (torch.bfloat16, (BATCH, SEQ, SLICE["n_heads"]), 64, (True,), (1, 2, 3)),
    (torch.float32, (2, 256, 2), 128, (True,), (1,)),
    (torch.float32, (1, 192, 3), 128, (True, False), (1,)),
    (torch.bfloat16, (1, 192, 3), 128, (True, False), (1,)),
    (torch.bfloat16, (LARGE_BATCH, SEQ, LARGE["n_heads"]), 128, (True,), (1, 2, 3)),
)


def kernel_rows(fa, d, q, k, v, do, plse, delta, readings, exp_per_s) -> dict:
    """Times each kernel at a timed shape (inputs q, k, v, do, causal)
    beside its plain version, its bound (the largest of `bound_terms`, the
    card's exp2 rate `exp_per_s`; in float32 the products at the CUDA
    cores' peak and 4-byte tiles) and the library yardstick; returns one
    row per kernel at head dim d, named `{kernel}_d{d}` in bf16 and
    `{kernel}_d{d}_f32` in float32."""
    import torch.nn.functional as F

    f32 = q.dtype == torch.float32
    dtype_name = "float32" if f32 else "bfloat16"
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
          f"{tuple(qt.shape)} {dtype_name}: forward {timings['flash_forward'][2]:.4f} ms; "
          f"kernel {timings['flash_forward'][0]:.4f} ms")
    rows = {}
    b, L, h, _ = q.shape
    for name, (ops, nbytes, exps) in bounds(b, L, h, d, elem=q.element_size()).items():
        ms, plain_ms, library_ms = timings[name]
        terms = bound_terms(ops, nbytes, exps, exp_per_s,
                            flops=PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS)
        term = max(terms, key=terms.get)
        row = rows[name] = {
            "name": f"{name}_d{d}" + ("_f32" if f32 else ""),
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "head_dim": d,
            "dtype": dtype_name,
            "shape": list(q.shape),
            "max_abs_err": max(err for err, _share in readings[name]),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": terms[term],
            # exponentials are operations too, on the special-function units
            "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term,
            "bound_terms_ms": terms,
            "library_ms": library_ms,
            "bound_share": terms[term] / ms,
            "blocks_per_sm": fa.blocks_per_sm(name, d, q.dtype),
        }
        print(f"{row['name']} {tuple(q.shape)}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms by {term} (" + ", ".join(
                  f"{t} {v:.4f}" for t, v in terms.items())
              + f"), share {row['bound_share']:.3f}, {ops / ms / 1e9:.1f} TFLOP/s, "
              f"{exps / ms / 1e9:.3f} T exp2/s, {row['blocks_per_sm']} blocks an SM)")
    return rows


def library_backward_f32(fa, q, k, v, do, lse, o) -> dict:
    """The float32 backward pair's yardstick: one `torch.autograd.grad`
    over `F.scaled_dot_product_attention` in float32 (causal; its f32
    backend, memory-efficient attention, computes dq, dk and dv in one
    call), on [B, H, L, D] views of the same inputs; its gradients are
    held against plain_dq / plain_dkv (atol 1e-4 + rtol 1e-3: another
    summation order, and no promise of full float32 products), and it is
    timed beside attention_delta + flash_dq + flash_dkv on the kernels' lse
    and o. Returns both times, as the kernels line's `backward_pair`."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)

    def call():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    delta = fa.attention_delta(do, o)
    failures = []
    readings = check_close(
        "SDPA float32 backward", [g.transpose(1, 2) for g in call()],
        (fa.plain_dq(q, k, v, do, lse, delta, True), *fa.plain_dkv(q, k, v, do, lse, delta, True)),
        (dict(atol=1e-4, rtol=1e-3),) * 3, failures,
    )
    if failures:
        raise AssertionError("the float32 backward yardstick disagrees with the plain "
                             "versions:\n" + "\n".join(failures))

    def kernels():
        dd = fa.attention_delta(do, o)
        fa.flash_dq(q, k, v, do, lse, dd, True)
        fa.flash_dkv(q, k, v, do, lse, dd, True)

    library_ms, kernels_ms = time_ms(call), time_ms(kernels)
    print(f"library yardstick autograd of F.scaled_dot_product_attention float32 (causal) "
          f"{tuple(qt.shape)}, dq, dk, dv in one call: {library_ms:.4f} ms (vs plain "
          f"(dq, dk, dv) {reading_text(readings)}); kernels attention_delta + flash_dq + "
          f"flash_dkv: {kernels_ms:.4f} ms")
    return {"library_call": "torch.autograd.grad(F.scaled_dot_product_attention) float32",
            "library_ms": library_ms, "kernels_ms": kernels_ms}


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
    head dim's timed shape, {head dim: row by kernel}, and the backward
    pair's yardstick by head dim. Prints every check's readings (max |err|
    and share of the limit, per output) and raises after the last if any
    was beyond its limit."""
    failures = []
    timed_inputs = {}
    for dtype, shape, d, causals, seeds in KERNEL_CHECKS:
        for seed in seeds:
            q, k, v, do = attention_inputs(*shape, d, dtype, seed=seed)
            for causal in causals:
                tag = f"{dtype} {tuple(q.shape)} causal={causal} seed {seed}"
                po, plse, readings = kernel_checks(fa, q, k, v, do, causal, tag, failures)
            # each head dim's last check is its timed shape (bf16,
            # causal), timed on its first seed's inputs
            if seed == seeds[0]:
                timed_inputs[d] = (q, k, v, do, plse, fa.attention_delta(do, po), readings)
    if failures:
        raise AssertionError("kernels disagree with their plain versions:\n"
                             + "\n".join(failures))
    rows, pairs = {}, {}
    exp_per_s = exp_rate()
    print(f"exp2 rate: {exp_per_s:.4e} a second ({SFU_PER_SM_CLOCK} a clock on each of "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs at the top SM clock)")
    for d, (q, k, v, do, plse, delta, readings) in timed_inputs.items():
        pairs[d] = library_backward(fa, q, k, v, do)
        rows[d] = kernel_rows(fa, d, q, k, v, do, plse, delta, readings, exp_per_s)
    # the zoo default's main path runs the float32 kernels at head dim 16:
    # their own rows at its shape, beside the bf16 kernels'
    q, k, v, do = attention_inputs(BATCH, SEQ, ZOO_DEFAULT["n_heads"], 16, torch.float32, 1)
    tag = f"{q.dtype} {tuple(q.shape)} causal=True seed 1 (timed)"
    po, plse, readings = kernel_checks(fa, q, k, v, do, True, tag, failures)
    if failures:
        raise AssertionError("\n".join(failures))
    rows["16_f32"] = kernel_rows(fa, 16, q, k, v, do, plse, fa.attention_delta(do, po),
                                 readings, exp_per_s)
    pairs["16_f32"] = library_backward_f32(fa, q, k, v, do, plse, po)
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
        name = kernel and re.search(r"(fa_(?:fwd|dq|dkv)(?:_bf16)?_kernel)ILi(\d+)E", kernel)
        if "spill stores" in line and name and name.group(1) in NO_SPILL:
            stores, loads = (int(x.split()[0]) for x in line.split(",")[1:3])
            if stores or loads:
                raise AssertionError(f"{kernel} spills: {line.strip()}")
        found = re.search(r"Used (\d+) registers", line)
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
    for forward in (lambda *a: tlm.plain_forward(*a)[0], tlm.reference_forward):
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
    servicer, _eval, _ckpt = build_job(spec, dispatcher, grads_to_wait=1)
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


def write_shards(data_dir, n_files, vocab=SLICE["vocab"]):
    from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records

    os.makedirs(data_dir)
    for i in range(n_files):
        write_learnable_token_records(os.path.join(data_dir, f"shard-{i}.rio"),
                                      SHARD_RECORDS, SEQ, vocab, seed=i)


def zoo_model(model_params):
    """The zoo's model as `--model_params model_params` builds it."""
    from elasticdl_tpu_torch.api.model_spec import get_model_spec

    return get_model_spec(ZOO, "transformer_lm_zoo.custom_model", model_params).model


def master_argv(data_dir, num_workers, output, model_params=SLICE_PARAMS, batch=BATCH,
                task_records=TASK_RECORDS):
    """The port's master command line for the zoo's transformer on the
    card (the slice's model by default; no `--model_params` flag when
    `model_params` is empty, as a user runs the zoo's default)."""
    return [
        "--model_zoo", ZOO, "--model_def", "transformer_lm_zoo.custom_model",
        *(["--model_params", model_params] if model_params else []),
        "--minibatch_size", str(batch),
        "--training_data_dir", data_dir, "--records_per_task", str(task_records),
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


def check_params(params, what, model_params=SLICE_PARAMS):
    """Finite, and moved from both workers' lazy inits (seeds 0 and 1)."""
    from elasticdl_tpu_torch.common import codec

    flat = codec.ravel_np(params)
    if not np.isfinite(flat).all():
        raise AssertionError(f"{what}: the parameters are not finite")
    model = zoo_model(model_params)
    for seed in (0, 1):
        if np.array_equal(flat, codec.ravel_np(model.init_params(seed))):
            raise AssertionError(f"{what}: the parameters did not move from init {seed}")


def summed_launches(summaries) -> dict:
    """The workers' launch counts, {f"{kernel}_d{head dim}": launches},
    summed over the workers' summaries."""
    keys = next(iter(summaries.values()))["launches"]
    return {key: sum(s["launches"][key] for s in summaries.values()) for key in keys}


# the reference's default per-step depth under --use_async
# (`common/args.resolve_step_pipeline`'s auto)
DEFAULT_ASYNC_DEPTH = 4
# each 2-worker window phase's background pulls and staged models folded
# in, summed over its workers: the page-in is driven when one shows a pull
PAGE_IN: dict = {}
# steady tokens/s of the sharded async phase, by depth (its within-call A/B)
SHARDED_ASYNC_RATES: dict = {}


def pipeline_lines(name, summaries, depth) -> list:
    """Print each worker's per-step pipeline: its depth, the reports
    joined, the batches trained again after a rejection and its
    sync_wait seconds. Returns the failures: a worker not at `depth`, or
    one whose reports joined are not its steps but the first (the job's
    first batch pulls the model through the serial loop)."""
    failures = []
    for wid, s in sorted(summaries.items()):
        print(f"{name} worker {wid} pipeline: depth {s['step_pipeline']}, "
              f"{s['step_reports_joined']} reports joined, {s['step_retrained']} batches "
              f"trained again, sync_wait {s['phase_seconds'].get('sync_wait', 0.0):.3f} s")
        if s["step_pipeline"] != depth:
            failures.append(f"{name} worker {wid} at depth {s['step_pipeline']}, {depth} asked")
        dispatched = s["steps_accepted"] - (1 if s["steps_accepted"] else 0)
        if depth and s["step_reports_joined"] != dispatched:
            failures.append(f"{name} worker {wid} joined {s['step_reports_joined']} reports "
                            f"for {s['steps_accepted']} accepted steps")
    return failures


def page_in_line(name, summaries) -> None:
    """Print each worker's background pulls and staged models folded in,
    and record their sums under `name` in PAGE_IN."""
    pulls = sum(s["bg_pulls"] for s in summaries.values())
    applied = sum(s["staged_applied"] for s in summaries.values())
    print(f"{name} page-in: " + ", ".join(
        f"worker {wid} {s['bg_pulls']} background pulls, {s['staged_applied']} folded in"
        for wid, s in sorted(summaries.items())) + f"; {pulls} pulls, {applied} folded in all")
    PAGE_IN[name] = (pulls, applied)


def phase_process_job(tmp, name="process", model_params=SLICE_PARAMS) -> dict:
    """`python -m elasticdl_tpu_torch.master.main ... --worker_backend
    process` with `--model_params model_params` (none when empty), run in
    this process through `run(argv)`: 2 worker processes on the card, 2
    shards of 64 records, 16 updates; each worker's kernels launched at
    the model's head dim only, with no fallback. Returns the kernels'
    launches summed over the workers."""
    from elasticdl_tpu_torch.common.constants import ENV_WORKER_LOG_DIR
    from elasticdl_tpu_torch.master import main as master_main
    from elasticdl_tpu_torch.master.checkpoint import load_model_file
    from elasticdl_tpu_torch.worker.main import read_summaries

    cfg = zoo_model(model_params).cfg
    data, log_dir = os.path.join(tmp, f"{name}-data"), os.path.join(tmp, f"{name}-logs")
    with logs_on_failure(log_dir):
        output = os.path.join(tmp, f"{name}.ckpt")
        write_shards(data, 2, cfg.vocab)
        steps = 2 * SHARD_RECORDS // BATCH
        os.environ[ENV_WORKER_LOG_DIR] = log_dir
        try:
            t0 = time.perf_counter()
            rc, master = master_main.run(master_argv(data, 2, output, model_params))
            wall = time.perf_counter() - t0
        finally:
            del os.environ[ENV_WORKER_LOG_DIR]
        if rc != 0:
            raise AssertionError(f"master.main exited {rc}")
        model = load_model_file(output)
        if model.version != steps:
            raise AssertionError(f"--output version {model.version}, {steps} expected")
        check_params(model.params, f"{name} job", model_params)
        summaries = read_summaries(log_dir)
        card = torch.cuda.get_device_name(0)
        if sorted(summaries) != [0, 1]:
            raise AssertionError(f"worker summaries of {sorted(summaries)}, of [0, 1] expected")
        accepted = sum(s["steps_accepted"] for s in summaries.values())
        if accepted != steps:
            raise AssertionError(f"the workers' accepted steps sum to {accepted}, not {steps}")
        for wid, s in summaries.items():
            want = want_launches(cfg.head_dim, dict.fromkeys(
                KERNELS, cfg.n_layers * s["steps_computed"]))
            if s["device"] != card:
                raise AssertionError(f"worker {wid} ran on {s['device']!r}, not {card!r}")
            if s["launches"] != want or s["attention_fallbacks"]:
                raise AssertionError(f"worker {wid} launches {s['launches']}, {want} expected "
                                     f"({s['steps_computed']} steps computed), fallbacks "
                                     f"{s['attention_fallbacks']}")
        exactness = {k: master[k] for k in ("version", "init_version", "applied_update_steps")}
        print(f"{name} job (--model_params {model_params!r}): rc {rc}, version {model.version}, "
              f"{wall:.2f} s, "
              f"{steps * BATCH * SEQ / wall:.1f} tokens/s over the whole run (worker boot "
              f"included), {steady_tokens_per_s(summaries):.1f} tokens/s between the first "
              f"and last accepted steps; exactness {exactness}")
        for wid, s in summaries.items():
            recomputes = s["steps_computed"] - s["steps_accepted"]
            print(f"{name} job worker {wid} on {s['device']}: {s['steps_accepted']} steps "
                  f"accepted, {s['steps_computed']} computed ({recomputes} stale recomputes), "
                  f"phase seconds {rounded(s['phase_seconds'])}, client seconds "
                  f"{rounded(s['rpc_seconds'])} (codec {rounded(s['rpc_codec_seconds'])}), "
                  f"launches {s['launches']}")
        server = master["server"]
        print(f"{name} job master: server handler seconds {rounded(server['handler_seconds'])}, "
              f"codec seconds {rounded(server['codec_seconds'])}, calls {server['calls']}")
        # the socket hop: each method's client wall clock less the client's
        # codec and the server's handler and codec time, over both workers
        hop = {
            m: sum(s["rpc_seconds"].get(m, 0.0) - s["rpc_codec_seconds"].get(m, 0.0)
                   for s in summaries.values())
            - server["handler_seconds"][m] - server["codec_seconds"][m]
            for m in server["calls"]
        }
        print(f"{name} job socket hop (s, both workers): {rounded(hop)}")
        return summed_launches(summaries)


def window_steady(window_log, batch=BATCH) -> float:
    """Tokens/s from the first to the last window sync that landed."""
    log = sorted(window_log)
    steps = sum(n for _t, n, _loss in log[1:])
    return steps * batch * SEQ / (log[-1][0] - log[0][0])


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


# the local-steps ladder with the adaptive wire plane: k windows a push
LADDER_K, LADDER_STEPS = 2, 32


def phase_window_ladder_adaptive(fa, tmp):
    """The base transformer at full width in-process in window mode, W 4,
    with the local-steps ladder and the adaptive wire plane
    (`sync_local_steps=2, sync_adaptive="on"`): 32 steps in tasks of 8,
    so each task's 8 steps go out as one push. Checks the exactness
    block at init + 32, 4 pushes of 8 steps each under one report key
    (`.w0` of its task), the decision log (4 rounds, the first the
    bf16 cold start with no link estimate, each form a rung of
    `sync_policy.WIRE_FORMS`), every push's wire bytes at most the
    float32 delta's, steps computed = applied, finite losses, moved
    parameters, the launches and no fallback. Prints the decisions and
    the bytes and rounds of each wire form. Returns the launches."""
    from elasticdl_tpu_torch.common import codec, sync_policy

    steps, per_task = LADDER_STEPS, WINDOW * LADDER_K
    dispatcher, servicer, master, worker, model = slice_job(
        os.path.join(tmp, "ladder.rio"), BATCH * steps, task_records=BATCH * per_task,
        local_updates=WINDOW, sync_local_steps=LADDER_K, sync_adaptive="on",
    )
    pushes = []
    master._intercept = {"ReportLocalUpdate": lambda req: pushes.append(
        (req["report_key"], req["steps"], codec.delta_nbytes(req["delta_flat"]))) or req}
    reset_counts(fa)
    t0 = time.perf_counter()
    ok = worker.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fallbacks = read_counts(fa)
    worker.close()

    ex = servicer.exactness()
    n = sum(p.numel() for p in model.parameters())
    decisions = worker.sync_decisions
    windows = list(worker.window_log)
    print(f"ladder + adaptive (in-process, W {WINDOW}, k {LADDER_K}): {len(pushes)} pushes "
          f"(key, steps, wire bytes) {pushes}, exactness {ex}; decisions {decisions}; wire "
          f"forms {worker.wire_forms}; {window_steady(windows):.1f} tokens/s from the first to "
          f"the last push, {steps * BATCH * SEQ / wall:.1f} over the run ({wall:.2f} s)")
    failures = []
    if not ok or not dispatcher.finished():
        failures.append("the job did not finish cleanly")
    if ex != {"version": steps, "init_version": 0, "applied_update_steps": steps}:
        failures.append(f"exactness {ex}, {steps} steps expected")
    if [(k.rsplit(".w", 1)[1], st) for k, st, _b in pushes] != [("0", per_task)] * (
            steps // per_task):
        failures.append(f"pushes {pushes}: {steps // per_task} of {per_task} steps, one a task")
    if any(b > 4 * n for _k, _s, b in pushes):
        failures.append(f"a push over the float32 delta's {4 * n} bytes: {pushes}")
    if (len(decisions) != len(pushes) or decisions[0]["form"] != sync_policy.COLD_START_FORM
            or decisions[0]["link_mbps"] is not None
            or any(d["form"] not in sync_policy.WIRE_FORMS for d in decisions)):
        failures.append(f"decision log {decisions}: a bf16 cold start, one a push")
    if worker.steps_computed != steps or worker.steps_accepted != steps:
        failures.append(f"{worker.steps_computed} computed, {worker.steps_accepted} accepted")
    losses = [loss for _t, _n, loss in windows]
    if not losses or not all(math.isfinite(x) for x in losses):
        failures.append(f"losses not finite: {losses}")
    want = want_launches(64, dict.fromkeys(KERNELS, SLICE["n_layers"] * steps))
    if launches != want or fallbacks:
        failures.append(f"launches {launches}, {want} expected, fallbacks {fallbacks}")
    final, _aux, _v = servicer.get_params_copy()
    if np.array_equal(codec.ravel_np(final), codec.ravel_np(model.init_params(0))):
        failures.append("the parameters did not move")
    if failures:
        raise AssertionError("ladder + adaptive:\n" + "\n".join(failures))
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


def spec_job(path, model_params, batch, n_records, task_records, **worker_kw):
    """The zoo's transformer built through its entry point (`get_model_spec`
    with `model_params`, as `--model_params` gives it): an in-process
    master/PS and one worker on the card over `n_records` token records of
    SEQ tokens in tasks of `task_records`; `worker_kw` selects window mode."""
    from elasticdl_tpu_torch.api.model_spec import get_model_spec
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
    from elasticdl_tpu_torch.testing import InProcessMaster, build_job
    from elasticdl_tpu_torch.worker.worker import Worker

    spec = get_model_spec(ZOO, "transformer_lm_zoo.custom_model", model_params)
    write_learnable_token_records(path, n_records, SEQ, spec.model.cfg.vocab, seed=0)
    dispatcher = TaskDispatcher({path: n_records}, {}, {}, task_records, 1, shuffle_seed=0)
    servicer, _eval, _ckpt = build_job(spec, dispatcher, grads_to_wait=1)
    master = InProcessMaster(servicer)
    worker = Worker(0, master, spec, minibatch_size=batch, device="cuda", seed=0, **worker_kw)
    return dispatcher, servicer, master, worker, spec.model


def check_run(what, ok, dispatcher, servicer, worker, model, launches, fallbacks, steps,
              forward_per_layer=1):
    """The checks of one in-process run: a clean finish, the exactness
    block with every step applied once, steps computed = applied, finite
    losses, moved parameters, no fallback, and the counted launches at the
    model's head dim only: dq and dk+dv once a layer a step computed, the
    forward `forward_per_layer` times (2 under remat, whose recompute
    reruns the layer's forward, ctypes launch included)."""
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
    d = model.cfg.head_dim
    if fallbacks:
        raise AssertionError(f"{what}: {fallbacks} attention calls fell back at head dim {d}")
    n = model.cfg.n_layers * steps
    want = want_launches(d, {"flash_forward": forward_per_layer * n, "flash_dq": n,
                             "flash_dkv": n})
    if launches != want:
        raise AssertionError(f"{what}: kernel launches {launches}, {want} expected")
    final, _aux, _v = servicer.get_params_copy()
    flat = codec.ravel_np(final)
    if not np.isfinite(flat).all() or np.array_equal(flat, codec.ravel_np(model.init_params(0))):
        raise AssertionError(f"{what}: the parameters are not finite or did not move")


def phase_zoo_default(fa, tmp):
    """The zoo's default model (`custom_model()` with no --model_params:
    vocab 128, d_model 64, 4 heads of 16, d_ff 128, 2 layers) on the card
    through the kernels at head dim 16, over b8 x s1024 token records:
    ZOO_STEPS per-step updates as a user gets it (float32 compute: the
    CUDA-core kernels), the same with `dtype=bfloat16` (the tensor-core
    kernels), then ZOO_WINDOW_STEPS window steps in bfloat16 (`--local_updates
    4 --sync_dtype bfloat16`). Each run is held to `check_run`. Returns
    the launches of each run by its column in the kernels line."""
    window = dict(local_updates=WINDOW, sync_dtype="bfloat16")
    counts = {}
    for column, params, steps, task_records, worker_kw in (
        ("zoo_launches", "", ZOO_STEPS, BATCH * ZOO_STEPS // 2, {}),
        ("zoo_bf16_launches", "dtype=bfloat16", ZOO_STEPS, BATCH * ZOO_STEPS // 2, {}),
        ("zoo_window_launches", "dtype=bfloat16", ZOO_WINDOW_STEPS, BATCH * WINDOW, window),
    ):
        dispatcher, servicer, master, worker, model = spec_job(
            os.path.join(tmp, f"{column}.rio"), params, BATCH, BATCH * steps, task_records,
            **worker_kw)
        if {k: getattr(model.cfg, k) for k in ZOO_DEFAULT} != ZOO_DEFAULT:
            raise AssertionError(f"the zoo's default width changed: {model.cfg}")
        reset_counts(fa)
        t0 = time.perf_counter()
        ok = worker.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, fallbacks = read_counts(fa)
        worker.close()
        if worker_kw:  # from the first to the last window sync
            losses = [round(x, 4) for _t, _n, x in worker.window_log]
            steady = window_steady(worker.window_log)
        else:  # over steps 2 to the last
            losses = [round(x, 4) for _t, x in worker.step_log]
            times = [t for t, _loss in worker.step_log]
            steady = (len(times) - 1) * BATCH * SEQ / (times[-1] - times[0])
        print(f"zoo default ({column}, --model_params {params!r}: "
              f"{sum(p.numel() for p in model.parameters()):,} params, {model.cfg.dtype}, head dim "
              f"{model.cfg.head_dim}, {worker_kw or 'per-step'}): {steps} steps in {wall:.2f} s "
              f"({steps * BATCH * SEQ / wall:.1f} tokens/s, model init included; steady "
              f"{steady:.1f}), exactness {servicer.exactness()}, losses {losses}, launches "
              f"{launches}, fallbacks {fallbacks}; worker phases {rounded(worker.phase_seconds)}, "
              f"servicer handlers {rounded(master.handler_seconds)}")
        check_run(f"zoo default {column}", ok, dispatcher, servicer, worker, model, launches,
                  fallbacks, steps)
        counts[column] = launches
    return counts


def phase_zoo_head_dim8(fa, tmp):
    """The zoo's default width with `--model_params n_heads=8` (head dim 8,
    the width of `bench_transformer.py`'s CPU-size base config, which no
    kernel takes) trains one step on the card through the dispatcher's
    fallback: the fallback stays driven on the card."""
    dispatcher, servicer, _master, worker, model = spec_job(
        os.path.join(tmp, "zoo-head-dim8.rio"), "n_heads=8", BATCH, BATCH, BATCH)
    reset_counts(fa)
    ok = worker.run()
    launches, fallbacks = read_counts(fa)
    worker.close()
    ex = servicer.exactness()
    head_dim = model.cfg.head_dim
    print(f"zoo width with n_heads=8 (head_dim {head_dim}) on the card: exactness {ex}, losses "
          f"{[round(x, 4) for _t, x in worker.step_log]}, attention fallbacks {fallbacks}, "
          f"kernel launches {launches}")
    if not ok or not dispatcher.finished() or ex["applied_update_steps"] != 1 or (
        ex["version"] != 1
    ):
        raise AssertionError(f"the head-dim-8 config did not train one step: {ex}")
    if not all(math.isfinite(x) for _t, x in worker.step_log):
        raise AssertionError("the head-dim-8 config's loss is not finite")
    if fallbacks <= 0 or any(launches.values()):
        raise AssertionError(f"the head-dim-8 config did not go through the fallback alone: "
                             f"{fallbacks} fallbacks, launches {launches}")


def peak_step_memory(cfg, batch, settings=(("off", False, ""), ("full", True, ""),
                                           ("dots", True, "dots"))) -> dict:
    """Peak device memory (GiB above the parameters, the gradient and the
    batch) of one forward + backward of `cfg` at `batch` x SEQ under each
    remat setting (name, remat, policy), from the same host init; not part
    of the counted paths."""
    import dataclasses

    from elasticdl_tpu_torch.common import codec
    from elasticdl_tpu_torch.models import transformer_lm as tlm

    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (batch, SEQ + 1))
    ).cuda()
    params = codec.tree_map(lambda a: torch.from_numpy(a).cuda().requires_grad_(),
                            tlm.init_params(np.random.default_rng(0), cfg))
    leaves = codec.tree_leaves(params)
    peaks = {}
    for name, remat, policy in settings:
        run_cfg = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        logits, aux = tlm.plain_forward(run_cfg, params, tokens[:, :-1])
        loss = tlm.token_cross_entropy(logits, tokens[:, 1:]) + cfg.aux_weight * aux.float()
        del logits, aux
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        grad_bytes = sum(g.numel() * g.element_size() for g in grads)
        peaks[name] = (torch.cuda.max_memory_allocated() - base - grad_bytes) / 2**30
        del grads, loss
    return peaks


def config_runs(fa, tmp, name, model_params, batch, steps, window_steps, n_params,
                check=None):
    """A config of the zoo's transformer from its `--model_params` string
    on the card, in-process at `batch` x SEQ: `steps` per-step updates,
    then `window_steps` window steps (`local_updates=4,
    sync_dtype="bfloat16"`, tasks of one window). Fails unless the model
    has `n_params` parameters; each run is held to `check_run` (the
    forward twice a layer a step under remat) and to `check(servicer,
    model)` when given. Prints each run's steady tokens/s, the host PS
    apply a step (per-step) and the sync split (window). Returns
    (per-step launches, window launches, the config)."""
    counts = []
    for window, n, task_records in ((0, steps, batch * steps // 2),
                                    (WINDOW, window_steps, batch * WINDOW)):
        mode = f"window (W {WINDOW}, bf16 EF deltas)" if window else "per-step"
        worker_kw = dict(local_updates=WINDOW, sync_dtype="bfloat16") if window else {}
        dispatcher, servicer, master, worker, model = spec_job(
            os.path.join(tmp, f"{name}-{window}.rio"), model_params, batch, batch * n,
            task_records, **worker_kw)
        cfg = model.cfg
        count = sum(p.numel() for p in model.parameters())
        if count != n_params:
            raise AssertionError(f"{name}: {count:,} parameters, {n_params:,} expected")
        reset_counts(fa)
        t0 = time.perf_counter()
        ok = worker.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, fallbacks = read_counts(fa)
        worker.close()
        windows = list(worker.window_log)
        losses = ([round(x, 4) for _t, _n, x in windows] if window
                  else [round(x, 4) for _t, x in worker.step_log])
        print(f"{name} {mode} ({count:,} params, head dim {cfg.head_dim}, remat "
              f"{cfg.remat_policy if cfg.remat else 'off'!r}, b{batch} x s{SEQ}): {n} steps, "
              f"exactness {servicer.exactness()}, losses {losses}, launches {launches}, "
              f"fallbacks {fallbacks}")
        check_run(f"{name} {mode}", ok, dispatcher, servicer, worker, model, launches,
                  fallbacks, n, forward_per_layer=2 if cfg.remat else 1)
        if check:
            check(servicer, model)
        tokens = batch * SEQ
        if window:
            steady = window_steady(windows, batch)
            print(f"{name} {mode}: {n * tokens / wall:.1f} tokens/s over the whole run "
                  f"({wall:.2f} s incl. model init), {steady:.1f} tokens/s from the first to "
                  f"the last window sync; a sync: "
                  + ", ".join(f"{k} {v / len(windows):.4f}"
                              for k, v in sorted(worker.sync_seconds.items()))
                  + f" s; PS add {master.handler_seconds['ReportLocalUpdate'] / len(windows):.4f}"
                  f" s a window; worker phases {rounded(worker.phase_seconds)}")
        else:
            times = [t for t, _loss in worker.step_log]
            print(f"{name} {mode}: {n * tokens / wall:.1f} tokens/s over the whole run "
                  f"({wall:.2f} s incl. model init), "
                  f"{(len(times) - 1) * tokens / (times[-1] - times[0]):.1f} tokens/s over "
                  f"steps 2-{n}; host PS apply (ReportGradient handler) "
                  f"{master.handler_seconds['ReportGradient'] / n:.4f} s a step; worker phases "
                  f"{rounded(worker.phase_seconds)}, wire codec {rounded(master.codec_seconds)}")
        counts.append(launches)
        del dispatcher, servicer, master, worker, model
        torch.cuda.empty_cache()
    return counts[0], counts[1], cfg


def phase_large(fa, tmp):
    """The reference's large config (d_model 1024, 8 heads of 128, d_ff
    4096, 16 layers, bf16, remat "dots", b16 x s1024; 218,137,600
    parameters) on the card: LARGE_STEPS per-step updates, then
    LARGE_WINDOW_STEPS window steps; then the peak memory of one step under
    each remat setting. Returns the kernels' launches of each run."""
    launches, window_launches, cfg = config_runs(
        fa, tmp, "large", LARGE_PARAMS, LARGE_BATCH, LARGE_STEPS, LARGE_WINDOW_STEPS,
        218_137_600)
    peaks = peak_step_memory(cfg, LARGE_BATCH)
    print(f"large config peak device memory of one step (forward + backward, GiB beyond "
          f"the f32 parameters, their gradient and the batch): remat off {peaks['off']:.2f}, "
          f"full {peaks['full']:.2f}, dots {peaks['dots']:.2f}")
    torch.cuda.empty_cache()
    return launches, window_launches


def phase_xl(fa, tmp):
    """The reference's xl config (d_model 2048, 16 heads of 128, d_ff 8192,
    8 layers, bf16, remat "dots", b8 x s1024; 436,242,432 parameters) on
    the card through the D = 128 kernels: XL_STEPS per-step updates, then
    XL_WINDOW_STEPS window steps; then the peak memory of one step under
    its remat "dots". Returns the kernels' launches of each run."""
    launches, window_launches, cfg = config_runs(
        fa, tmp, "xl", XL_PARAMS, XL_BATCH, XL_STEPS, XL_WINDOW_STEPS, XL_N_PARAMS)
    peaks = peak_step_memory(cfg, XL_BATCH, (("dots", True, "dots"),))
    print(f"xl config peak device memory of one step (forward + backward, GiB beyond the f32 "
          f"parameters, their gradient and the batch), remat dots: {peaks['dots']:.2f}")
    torch.cuda.empty_cache()
    return launches, window_launches


def check_moe_moved(servicer, model):
    """Every leaf of the MoE model moved, and in every layer the router
    and each expert's ew1 and ew2 slices: at 8,192 tokens a step over 8
    experts each expert takes tokens in every layer."""
    final, _aux, _v = servicer.get_params_copy()
    init = model.init_params(0)
    layers = final["layers"]
    for key in ("embed", "head", "ln_f"):
        if np.array_equal(final[key], init[key]):
            raise AssertionError(f"MoE: {key} did not move")
    for key, leaf in layers.items():
        for i in range(leaf.shape[0]):
            parts = range(leaf.shape[1]) if key in ("ew1", "ew2") else (None,)
            for e in parts:
                at = (i,) if e is None else (i, e)
                if np.array_equal(leaf[at], init["layers"][key][at]):
                    raise AssertionError(f"MoE: layers.{key}{list(at)} did not move")


def moe_route_probe(model, path, batch):
    """One `_route` call on a real batch: the first `batch` records of
    `path` through the model's init on the card; layer 0's routing: tokens
    routed to each expert, tokens kept under capacity, the dropped share
    and the aux. Not part of the counted paths."""
    from elasticdl_tpu_torch.common import codec
    from elasticdl_tpu_torch.data.recordio import RecordIOReader
    from elasticdl_tpu_torch.models import transformer_lm as tlm
    from elasticdl_tpu_torch.models import transformer_lm_zoo as zoo
    from elasticdl_tpu_torch.parallel import moe

    with RecordIOReader(path) as r:
        features, _labels = zoo.dataset_fn(list(r.read_range(0, batch)), "training")
    params = codec.tree_map(lambda a: torch.from_numpy(a).cuda(), model.init_params(0))
    calls, real = [], moe._route

    def recording(x, router_w, num_experts, capacity):
        out = real(x, router_w, num_experts, capacity)
        calls.append((x, router_w, capacity, out))
        return out

    moe._route = recording
    try:
        with torch.no_grad():
            tlm.plain_forward(model.cfg, params, torch.from_numpy(features).long().cuda())
    finally:
        moe._route = real
    x, router_w, capacity, (dispatch, _combine, aux) = calls[0]
    routed = torch.bincount(torch.argmax((x @ router_w).float(), dim=-1),
                            minlength=model.cfg.n_experts)
    kept = dispatch.float().sum(dim=(0, 2))
    t = x.shape[0]
    dropped = 1.0 - float(kept.sum()) / t
    print(f"MoE routing, layer 0 of the init on {batch} records ({t} tokens, capacity "
          f"{capacity} a expert): routed {routed.tolist()}, kept {kept.int().tolist()}, "
          f"dropped share {dropped:.4f}, aux {float(aux):.4f} (1.0 when balanced); "
          f"{len(calls)} routing calls ({model.cfg.n_layers} layers)")
    if len(calls) != model.cfg.n_layers or not math.isfinite(float(aux)):
        raise AssertionError(f"MoE probe: {len(calls)} routing calls, aux {float(aux)}")
    return dropped


def moe_profile(model_params, path, batch, steps=3):
    """The MoE step's device time split by torch.profiler (in-process,
    `steps` forward + backward of the config on the card, after one
    warm-up): the routing products (aten::mm with the experts' E*C slots
    in a dimension: dispatch and combine, forward and backward), the
    expert FFNs (aten::bmm), the attention kernels (fa_*) and the rest.
    Not part of the counted paths."""
    from torch.profiler import ProfilerActivity, profile

    from elasticdl_tpu_torch.common import codec
    from elasticdl_tpu_torch.data.recordio import RecordIOReader
    from elasticdl_tpu_torch.models import transformer_lm as tlm
    from elasticdl_tpu_torch.models import transformer_lm_zoo as zoo

    model = zoo_model(model_params)
    cfg = model.cfg
    with RecordIOReader(path) as r:
        features, labels = zoo.dataset_fn(list(r.read_range(0, batch)), "training")
    tokens = torch.from_numpy(features).long().cuda()
    targets = torch.from_numpy(labels).long().cuda()
    params = codec.tree_map(lambda a: torch.from_numpy(a).cuda().requires_grad_(),
                            model.init_params(0))
    leaves = codec.tree_leaves(params)
    slots = cfg.n_experts * max(1, math.ceil(batch * SEQ * cfg.capacity_factor
                                             / cfg.n_experts))

    def step():
        logits, aux = tlm.plain_forward(cfg, params, tokens)
        loss = tlm.token_cross_entropy(logits, targets) + cfg.aux_weight * aux.float()
        torch.autograd.grad(loss, leaves)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if total == 0:
        print("MoE profile: the profiler recorded no device time (not measured)")
        return
    parts = {"routing products": 0.0, "expert FFN": 0.0, "attention": 0.0}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if re.search(r"\bfa_(fwd|dq|dkv)", e.name):
                parts["attention"] += e.self_device_time_total
        elif e.name == "aten::bmm":
            parts["expert FFN"] += e.device_time_total
        elif e.name == "aten::mm" and any(slots in shape for shape in e.input_shapes
                                          if isinstance(shape, list)):
            parts["routing products"] += e.device_time_total
    parts = {k: v / 1e3 / steps for k, v in parts.items()}
    parts["rest"] = total - sum(parts.values())
    print(f"MoE profile (b{batch} x s{SEQ}, forward + backward, no optimizer): device time "
          f"{total:.2f} ms a step: " + ", ".join(
              f"{k} {v:.2f} ms ({v / total:.3f})" for k, v in parts.items()))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
              f"{e.count // steps:4d}x  {e.key[:90]}")


def phase_moe(fa, tmp):
    """The reference's MoE config (the base width, every FFN 8 experts of
    256, top-1 at capacity factor 2.0, bf16, b8 x s1024; 33,595,904
    parameters) on the card through the D = 64 kernels: MOE_STEPS
    per-step updates and MOE_WINDOW_STEPS window steps, each with every
    leaf, router and expert moved; one `_route` call on a real batch; the
    peak memory of one step; the device time split. Returns the kernels'
    launches of each run."""
    launches, window_launches, cfg = config_runs(
        fa, tmp, "moe", MOE_PARAMS, BATCH, MOE_STEPS, MOE_WINDOW_STEPS, MOE_N_PARAMS,
        check=check_moe_moved)
    if (cfg.n_experts, cfg.d_expert, cfg.capacity_factor) != (8, 256, 2.0):
        raise AssertionError(f"MoE config {cfg}")
    path = os.path.join(tmp, "moe-0.rio")
    moe_route_probe(zoo_model(MOE_PARAMS), path, BATCH)
    peaks = peak_step_memory(cfg, BATCH, (("off", False, ""),))
    print(f"MoE config peak device memory of one step (forward + backward, GiB beyond the f32 "
          f"parameters, their gradient and the batch), no remat: {peaks['off']:.2f}")
    torch.cuda.empty_cache()
    moe_profile(MOE_PARAMS, path, BATCH)
    torch.cuda.empty_cache()
    return launches, window_launches


def phase_moe_reference():
    """The MoE model's forward and backward on the card against the
    per-token reference loop (`reference_forward`: each token's argmax
    expert, gate x its FFN), float32, small shape, with capacity factor E
    (capacity = all T tokens) so nothing drops; the aux is not in the
    reference, so both sides take the cross-entropy's gradients."""
    from elasticdl_tpu_torch.common import codec
    from elasticdl_tpu_torch.convert import params_from_jax
    from elasticdl_tpu_torch.models import transformer_lm as tlm

    cfg = tlm.TransformerConfig(vocab=256, d_model=128, n_heads=2, d_ff=256, n_layers=2,
                                n_experts=4, d_expert=64, capacity_factor=4.0)
    host = tlm.init_params(np.random.default_rng(3), cfg)
    params = codec.tree_map(lambda t: t.cuda(), params_from_jax(host))
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab, (2, 129))
    ).cuda()
    leaves = codec.tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    results = []
    for forward in (lambda *a: tlm.plain_forward(*a)[0], tlm.reference_forward):
        logits = forward(cfg, params, tokens[:, :-1])
        loss = tlm.token_cross_entropy(logits, tokens[:, 1:])
        results.append((logits, *torch.autograd.grad(loss, leaves)))
    failures = []
    readings = check_close("MoE model logits and grads", results[0], results[1],
                           (MODEL_TOL,) * len(results[0]), failures)
    if failures:
        raise AssertionError("\n".join(failures))
    print(f"MoE model forward+backward (kernels, dense dispatch) vs the per-token reference, "
          f"f32 [2, 128], 4 experts, nothing dropped: max|err| "
          f"{max(err for err, _share in readings):.3e}")


def phase_window_process_job(tmp, name="window process", model_params=SLICE_PARAMS,
                             batch=BATCH, task_records=TASK_RECORDS, n_files=4) -> dict:
    """`master.main ... --local_updates 4 --sync_dtype bfloat16
    --worker_backend process` with 2 workers on the card over `n_files`
    shards of 64 records (the base model by default: 4 files, 32 steps;
    the large config at b16 in tasks of one window over 2 files: 8
    steps, cut from 16 since `phase_xl_sharded_processes` runs window
    mode as processes at the xl width). Checks rc, the `--output`
    version = the workers' applied steps = steps computed, finite moved
    parameters, and each worker's device, launches at the model's head
    dim (the forward twice a layer under remat) and no fallback. Returns
    the launches summed over the workers."""
    from elasticdl_tpu_torch.common.constants import ENV_WORKER_LOG_DIR
    from elasticdl_tpu_torch.master import main as master_main
    from elasticdl_tpu_torch.master.checkpoint import load_model_file
    from elasticdl_tpu_torch.worker.main import read_summaries

    cfg = zoo_model(model_params).cfg
    tag = name.replace(" ", "-")
    data, log_dir = os.path.join(tmp, f"{tag}-data"), os.path.join(tmp, f"{tag}-logs")
    with logs_on_failure(log_dir):
        output = os.path.join(tmp, f"{tag}.ckpt")
        write_shards(data, n_files, cfg.vocab)
        steps = n_files * SHARD_RECORDS // batch
        os.environ[ENV_WORKER_LOG_DIR] = log_dir
        try:
            t0 = time.perf_counter()
            rc, master = master_main.run(
                master_argv(data, 2, output, model_params, batch, task_records) + WINDOW_ARGS)
            wall = time.perf_counter() - t0
        finally:
            del os.environ[ENV_WORKER_LOG_DIR]
        if rc != 0:
            raise AssertionError(f"{name}: master.main (window mode) exited {rc}")
        model = load_model_file(output)
        summaries = read_summaries(log_dir)
        if sorted(summaries) != [0, 1]:
            raise AssertionError(f"worker summaries of {sorted(summaries)}, of [0, 1] expected")
        accepted = sum(s["steps_accepted"] for s in summaries.values())
        computed = sum(s["steps_computed"] for s in summaries.values())
        exactness = {k: master[k] for k in ("version", "init_version", "applied_update_steps")}
        windows = [w for s in summaries.values() for w in s["windows"]]
        print(f"{name} job (--model_params {model_params!r}, b{batch}): rc {rc}, version "
              f"{model.version}, {wall:.2f} s, {steps * batch * SEQ / wall:.1f} tokens/s over "
              f"the whole run (worker boot included), {window_steady(windows, batch):.1f} "
              f"tokens/s from the first to the last window sync; exactness {exactness}; steps "
              f"computed {computed}, accepted {accepted}")
        page_in_line(name, summaries)
        for wid, s in summaries.items():
            n = max(1, len(s["windows"]))
            print(f"{name} worker {wid} on {s['device']}: {s['steps_accepted']} steps in "
                  f"{len(s['windows'])} syncs, {s['merged_back']} merged-back absorbs, sync "
                  f"seconds per sync {rounded({k: v / n for k, v in s['sync_seconds'].items()})}, "
                  f"phase seconds {rounded(s['phase_seconds'])}, client seconds "
                  f"{rounded(s['rpc_seconds'])}, launches {s['launches']}, fallbacks "
                  f"{s['attention_fallbacks']}")
        server = master["server"]
        syncs = server["calls"].get("ReportLocalUpdate", 0)
        rpc = sum(s["sync_seconds"].get("rpc", 0.0) for s in summaries.values())
        add = server["handler_seconds"].get("ReportLocalUpdate", 0.0)
        print(f"{name} master: server handler seconds {rounded(server['handler_seconds'])}, "
              f"calls {server['calls']}; a sync: rpc {rpc / max(1, syncs):.4f} s (worker side), "
              f"PS add {add / max(1, syncs):.4f} s (ReportLocalUpdate handler, the servicer "
              f"lock included), {syncs} syncs")
        if model.version != steps or accepted != steps or exactness["version"] != steps:
            raise AssertionError(f"{name}: --output version {model.version}, workers' applied "
                                 f"steps {accepted}, exactness {exactness}: {steps} expected")
        if exactness["version"] != exactness["init_version"] + exactness["applied_update_steps"]:
            raise AssertionError(f"{name}: exactness block broken: {exactness}")
        if computed != accepted:
            raise AssertionError(f"{name}: {computed} steps computed for {accepted} applied")
        check_params(model.params, f"{name} job", model_params)
        card = torch.cuda.get_device_name(0)
        forward_per_layer = 2 if cfg.remat else 1
        for wid, s in summaries.items():
            n = cfg.n_layers * s["steps_computed"]
            want = want_launches(cfg.head_dim, {"flash_forward": forward_per_layer * n,
                                                "flash_dq": n, "flash_dkv": n})
            if s["device"] != card:
                raise AssertionError(f"{name} worker {wid} ran on {s['device']!r}, not {card!r}")
            if s["launches"] != want or s["attention_fallbacks"]:
                raise AssertionError(f"{name} worker {wid} launches {s['launches']}, {want} "
                                     f"expected, fallbacks {s['attention_fallbacks']}")
            if not all(math.isfinite(loss) for _t, _n, loss in s["windows"]):
                raise AssertionError(f"{name} worker {wid}: window losses not finite")
        return summed_launches(summaries)

# -- the sharded PS (--num_ps): xl as worker processes over shard processes,
# and the base transformer async per-step over inproc shards
PS_SHARD_MAIN = "elasticdl_tpu_torch.master.ps_shard_main"
XL_SHARDS = 4
SHARDED_ASYNC_SHARDS = 2
# record files of SHARD_RECORDS each: 16 updates of the base model at b8
# (cut from 4 files to keep the whole run in budget), and 8 steps of xl
# at b8, one window a worker (cut from 16)
SHARDED_FILES = 2
XL_SHARDED_FILES = 1


def shard_line(name, shards, syncs) -> str:
    """Each PS shard's push-apply and lock-wait seconds a push, and its
    pushes, from the master summary's `ps_shards`."""
    parts = []
    for st in shards:
        n = max(1, st["applied_pushes"] + st["duplicate_pushes"])
        parts.append(f"shard {st['shard_id']} v{st['version']} ({st['size']} params): apply "
                     f"{st['apply_seconds'] / n:.4f} s, lock wait "
                     f"{st['lock_wait_seconds'] / n:.4f} s a push over "
                     f"{st['applied_pushes']} pushes ({st['duplicate_pushes']} duplicate), "
                     f"{st['pulls']} pulls")
    return f"{name} PS shards ({syncs} syncs): " + "; ".join(parts)


def sharded_exactness(name, summary, steps) -> list:
    """A sharded job's exactness as the reference's own harness holds it
    (`elasticdl_tpu/chaos/scenario.py:1049-1057`): every shard at init +
    `steps` (the model's state), and the master's version mirror true to
    its identity (`version == init_version + applied_update_steps`) and
    never ahead. The mirror moves to the largest of the reports' shard
    minimums (`servicer.report_window_meta`, the reference's rule), so
    when two workers' last fan-outs cross between the shards it stays a
    window behind, as the reference's does (printed, not failed).
    Returns the failures."""
    ex = {k: summary[k] for k in ("version", "init_version", "applied_update_steps")}
    versions = [st["version"] for st in summary["ps_shards"]]
    failures = []
    if versions != [steps] * len(versions) or ex["init_version"] != 0:
        failures.append(f"shard versions {versions} from init {ex['init_version']}, "
                        f"{steps} each expected")
    if ex["version"] != ex["init_version"] + ex["applied_update_steps"] or not (
            0 < ex["version"] <= steps):
        failures.append(f"the master's mirror {ex} breaks its identity or passes {steps}")
    if not failures and ex["version"] != steps:
        print(f"{name}: the master's mirror at v{ex['version']} with every shard at v{steps}: "
              f"the last fan-outs crossed (the reference's max-of-minimums rule)")
    return failures


def check_sharded(name, rc, summary, workers, steps, model_params, shm=False):
    """The sharded job's common checks: rc 0, the shards' and the
    master's exactness (`sharded_exactness`), the workers' accepted and
    computed steps, each worker on the card with the model's launches and
    no fallback, finite losses, and (`shm`) every link on shm. Returns
    the failures."""
    cfg = zoo_model(model_params).cfg
    if rc != 0 or summary is None:
        return [f"{name}: master.main exited {rc}"]
    versions = [st["version"] for st in summary["ps_shards"]]
    failures = sharded_exactness(name, summary, steps)
    calls = summary["server"]["calls"]
    if calls.get("ReportGradient", 0) or calls.get("ReportLocalUpdate", 0):
        failures.append(f"the master took pushes ({calls}): they go to the shards")
    if sorted(workers) != [0, 1]:
        return failures + [f"worker summaries of {sorted(workers)}, of [0, 1] expected"]
    accepted = sum(s["steps_accepted"] for s in workers.values())
    computed = sum(s["steps_computed"] for s in workers.values())
    if accepted != steps or computed != steps:
        failures.append(f"steps accepted {accepted}, computed {computed}: {steps} expected")
    card = torch.cuda.get_device_name(0)
    forward_per_layer = 2 if cfg.remat else 1
    for wid, s in workers.items():
        n = cfg.n_layers * s["steps_computed"]
        want = want_launches(cfg.head_dim, {"flash_forward": forward_per_layer * n,
                                            "flash_dq": n, "flash_dkv": n})
        if s["device"] != card:
            failures.append(f"worker {wid} ran on {s['device']!r}, not {card!r}")
        if s["launches"] != want or s["attention_fallbacks"]:
            failures.append(f"worker {wid} launches {s['launches']}, {want} expected, "
                            f"fallbacks {s['attention_fallbacks']}")
        losses = s["losses"] + [loss for _t, _n, loss in s["windows"]]
        if not losses or not all(math.isfinite(x) for x in losses):
            failures.append(f"worker {wid}: losses {losses[:4]}... not all finite")
        if s["shard_versions"] is None or len(s["shard_versions"]) != len(versions):
            failures.append(f"worker {wid} saw shard versions {s['shard_versions']}")
        if shm and (s["tier"] != "shm" or s["ps_tiers"] != ["shm"] * len(versions)):
            failures.append(f"worker {wid} links: master {s['tier']}, shards {s['ps_tiers']}; "
                            "shm asked")
    return failures


def phase_xl_sharded_processes(tmp):
    """The reference's xl config (436,242,432 parameters: 1.75 GB of
    float32, over the transport's 1 GiB frame) as 2 worker processes on
    the card over `--num_ps 4 --ps_mode process` (436 MB a slice), in
    window mode (W 4, bf16 EF deltas, b8, tasks of one window: 8 steps)
    over EDL_TRANSPORT=shm. The model's version-0 init goes in as a
    checkpoint file (`--checkpoint_filename_for_init`): the master seeds
    each shard with its slice, and the workers pull from the shards (the
    first ReportVariable would carry the whole tree through one frame).
    Checks rc 0, every shard's version and the master's at init + the
    applied window steps, finite losses, moved parameters (the
    `--output` against the init file), every link on shm, the D = 128
    launches, and no shard process or segment left. Prints steady
    tokens/s, each shard's apply and lock wait a push, the workers' rpc
    a sync. Returns the launches summed over the workers."""
    from elasticdl_tpu_torch.common import codec
    from elasticdl_tpu_torch.master.checkpoint import load_model_file, save_model_file
    from elasticdl_tpu_torch.worker.main import read_summaries

    name = "xl sharded processes"
    model = zoo_model(XL_PARAMS)
    data, logs = os.path.join(tmp, "xl-sharded-data"), os.path.join(tmp, "xl-sharded-logs")
    write_shards(data, XL_SHARDED_FILES, model.cfg.vocab)
    steps = XL_SHARDED_FILES * SHARD_RECORDS // XL_BATCH
    init_path, output = os.path.join(tmp, "xl-init.ckpt"), os.path.join(tmp, "xl-sharded.ckpt")
    t0 = time.perf_counter()
    init = model.init_params(0)
    save_model_file(init_path, init, 0)
    init_flat = codec.ravel_np(init)
    del init
    print(f"{name}: the init checkpoint ({os.path.getsize(init_path)} bytes) written in "
          f"{time.perf_counter() - t0:.2f} s")
    argv = (master_argv(data, 2, output, XL_PARAMS, XL_BATCH, XL_BATCH * WINDOW) + WINDOW_ARGS
            + ["--num_ps", str(XL_SHARDS), "--ps_mode", "process",
               "--checkpoint_filename_for_init", init_path])
    with tier_dir() as uds:
        rc, summary, wall = run_master(argv, logs, {"EDL_TRANSPORT": "shm", "EDL_UDS_DIR": uds})
    with logs_on_failure(logs):
        workers = read_summaries(logs)
        failures = check_sharded(name, rc, summary, workers, steps, XL_PARAMS, shm=True)
        if failures:
            raise AssertionError(f"{name}:\n" + "\n".join(failures))
        windows = [w for s in workers.values() for w in s["windows"]]
        print(f"{name} ({XL_SHARDS} shard processes, 2 workers, W {WINDOW}, b{XL_BATCH}, "
              f"{steps} steps, shm): rc {rc} in {wall:.2f} s, "
              f"{window_steady(windows, XL_BATCH):.1f} tokens/s from the first to the last "
              f"window sync, exactness v{summary['version']}, master calls "
              f"{summary['server']['calls']}")
        print(shard_line(name, summary["ps_shards"], len(windows)))
        for wid, s in sorted(workers.items()):
            n = max(1, len(s["windows"]))
            print(f"{name} worker {wid} on {s['device']}: links master {s['tier']}, shards "
                  f"{s['ps_tiers']}; {s['steps_accepted']} steps in {len(s['windows'])} syncs, "
                  f"{s['merged_back']} merged-back absorbs, sync seconds a sync "
                  f"{rounded({k: v / n for k, v in s['sync_seconds'].items()})}, shard links' "
                  f"seconds {rounded(s['ps_rpc_seconds'])}, phase seconds "
                  f"{rounded(s['phase_seconds'])}, peak {s['peak_memory_bytes'] / 2**30:.2f} "
                  f"GiB, launches {s['launches']}")
        final = codec.ravel_np(load_model_file(output).params)
        if final.shape != init_flat.shape or not np.isfinite(final).all():
            raise AssertionError(f"{name}: the --output model is not finite or not xl")
        moved = float(np.abs(final - init_flat).max())
        if moved == 0.0:
            raise AssertionError(f"{name}: the parameters did not move from the init")
        print(f"{name}: the --output model moved by up to {moved:.4g} from the init")
        left = shard_processes(PS_SHARD_MAIN)
        segments = [n for n in os.listdir("/dev/shm") if n.startswith("edltshm.")]
        if left or segments:
            raise AssertionError(f"{name}: shard processes {left}, segments {segments} left")
        return summed_launches(workers)


def phase_sharded_async(tmp, depth=None):
    """The base transformer async per-step as 2 worker processes over
    `--num_ps 2 --ps_mode inproc` (the shards in the master's process,
    each running the zoo's clip + Adam on its slice), 16 updates of b8,
    with one checkpoint at v16 carrying each shard's optimizer state; at
    the reference's default per-step depth (4 reports in flight under
    `--use_async`), or at `--step_pipeline depth` (the 0 twin: serial
    reports, the within-call A/B). Checks rc 0, every shard's version and
    the master's at the applied steps, steps accepted = computed (async
    accepts every report), each worker at the depth with a report joined
    a step, the D = 64 launches, finite losses, moved parameters, the
    checkpoint's per-shard Adam state (its count at each shard's
    version). Prints tokens/s, each worker's pipeline and each shard's
    apply and lock wait a push. Returns the launches summed over the
    workers."""
    from elasticdl_tpu_torch.master.checkpoint import load_model_file
    from elasticdl_tpu_torch.worker.main import read_summaries

    want = DEFAULT_ASYNC_DEPTH if depth is None else depth
    name = "sharded async" + ("" if depth is None else f" depth {depth}")
    # a directory of its own per run: the phase may run more than once
    root = tempfile.mkdtemp(prefix=name.replace(" ", "-"), dir=tmp)
    data, logs = os.path.join(root, "data"), os.path.join(root, "logs")
    ckpt_dir, output = os.path.join(root, "ckpt"), os.path.join(root, "final.ckpt")
    write_shards(data, SHARDED_FILES)
    steps = SHARDED_FILES * SHARD_RECORDS // BATCH
    argv = master_argv(data, 2, output) + [
        "--use_async", "--num_ps", str(SHARDED_ASYNC_SHARDS), "--ps_mode", "inproc",
        "--checkpoint_dir", ckpt_dir, "--checkpoint_steps", str(steps)]
    if depth is not None:
        argv += ["--step_pipeline", str(depth)]
    rc, summary, wall = run_master(argv, logs)
    with logs_on_failure(logs):
        workers = read_summaries(logs)
        failures = check_sharded(name, rc, summary, workers, steps, SLICE_PARAMS)
        if not failures:
            failures = pipeline_lines(name, workers, want)
        if failures:
            raise AssertionError(f"{name}:\n" + "\n".join(failures))
        rate = steady_tokens_per_s(workers)
        SHARDED_ASYNC_RATES[want] = rate
        print(f"{name} ({SHARDED_ASYNC_SHARDS} inproc shards, 2 workers, b{BATCH}, {steps} "
              f"updates, depth {want}): rc {rc} in {wall:.2f} s, {rate:.1f} tokens/s "
              f"between the first and last accepted steps, master calls "
              f"{summary['server']['calls']}")
        print(shard_line(name, summary["ps_shards"], steps))
        for wid, s in sorted(workers.items()):
            print(f"{name} worker {wid}: links master {s['tier']}, shards {s['ps_tiers']}; "
                  f"{s['steps_accepted']} steps, phase seconds {rounded(s['phase_seconds'])}, "
                  f"shard links' seconds {rounded(s['ps_rpc_seconds'])}, master link "
                  f"{rounded(s['rpc_seconds'])}, launches {s['launches']}")
        check_params(load_model_file(output).params, f"{name} job")
        ckpts = sorted(os.listdir(ckpt_dir)) if os.path.isdir(ckpt_dir) else []
        if ckpts != [f"model_v{steps}.ckpt"]:
            raise AssertionError(f"{name}: checkpoints {ckpts}, model_v{steps}.ckpt expected")
        opt = load_model_file(os.path.join(ckpt_dir, ckpts[0])).opt_state or {}
        shards = opt.get("shards") or []
        counts = [int(np.asarray(leaves[0])) for leaves in shards if leaves]
        if opt.get("kind") != "sharded" or counts != [steps] * SHARDED_ASYNC_SHARDS:
            raise AssertionError(f"{name}: checkpoint optimizer state {opt.get('kind')!r} with "
                                 f"Adam counts {counts}; sharded, {steps} on each shard expected")
        print(f"{name}: checkpoint {ckpts[0]} with the sharded optimizer state of "
              f"{len(shards)} shards (Adam counts {counts}, {len(shards[0])} leaves each)")
        return summed_launches(workers)


# -- the shard recovery plane: a SIGKILLed PS shard process (the base
# transformer) and a SIGKILLed KV shard process (deepfm) ridden out
FAILOVER_FILES = 4  # of SHARD_RECORDS: 32 window steps at b8


def shard_killer(kind, shard, ready, box):
    """master.main's `on_start`: once `ready(servicer)`, SIGKILL the
    `kind` ("ps" or "kv") group's shard process `shard`, noting its pid
    and the wall clock of the kill in `box`."""
    def on_start(servicer):
        group = servicer.ps_group if kind == "ps" else servicer.kv_group

        def watch():
            deadline = time.monotonic() + 600
            try:
                while not ready(servicer, group):
                    if time.monotonic() > deadline:
                        return
                    time.sleep(0.005)
            finally:
                getattr(ready, "close", lambda: None)()
            box["pid"] = group.procs[shard].pid
            box["kill"] = time.time()
            os.kill(box["pid"], signal.SIGKILL)

        threading.Thread(target=watch, name=f"kill-{kind}{shard}", daemon=True).start()

    return on_start


class ps_pushes_applied:
    """A `ready` test for shard_killer: PS shard `shard`'s stats show its
    n-th applied push (read over one link, closed after)."""

    def __init__(self, shard, n):
        self.shard, self.n, self.client = shard, n, None

    def __call__(self, servicer, group):
        from elasticdl_tpu_torch.rpc.client import RpcClient

        if self.client is None:
            self.client = RpcClient(group.endpoints[self.shard])
        try:
            return self.client.call("PSStats", {}, timeout=10)["applied_pushes"] >= self.n
        except Exception:
            return False

    def close(self):
        if self.client is not None:
            self.client.close()


def check_failover(summary, kind, shard, box) -> list:
    """The recovery plane's checks: the kill happened, the one recovery is
    `kind` shard `shard` at generation 1 with nothing unrecoverable, and
    the group's generations moved that slot only. Returns the failures."""
    if summary is None:
        return ["master.main returned no summary"]
    failures = []
    if "kill" not in box:
        failures.append(f"{kind} shard {shard} was never killed")
    if summary["recoveries"] != [[kind, shard, 1]]:
        failures.append(f"recoveries {summary['recoveries']}, [[{kind!r}, {shard}, 1]] expected")
    if summary["unrecoverable"]:
        failures.append(f"unrecoverable shards {summary['unrecoverable']}")
    gens = summary["generations"][kind]
    if gens != [1 if i == shard else 0 for i in range(len(gens))]:
        failures.append(f"{kind} generations {gens}: slot {shard} at 1 only expected")
    return failures


def recovery_event_counts(metrics, kind) -> dict:
    """{event: count} of edl_recovery_events_total for `kind` in this
    process's metrics registry (the master's)."""
    rows = metrics.get_registry().snapshot().get("edl_recovery_events_total", [])
    return {r["labels"]["event"]: r["value"] for r in rows if r["labels"]["kind"] == kind}


def failover_seconds(tl, kill, first_push=None) -> str:
    """The recovery's timeline in seconds from the kill."""
    marks = [("detected", tl.get("detected")), ("fenced", tl.get("fenced")),
             ("restore upload accepted", tl.get("upload_accepted")),
             ("relaunched shard serving", tl.get("active")),
             ("first push accepted after it", first_push)]
    parts = [f"{name} {t - kill:.3f}" for name, t in marks if t is not None]
    boot = tl["relaunched"] - tl["relaunch_start"]
    return f"kill -> {', '.join(parts)} s; the relaunched process's boot {boot:.3f} s"


def phase_shard_failover(tmp):
    """The base transformer (d512, 8 heads of 64, 8 layers, bf16, b8 x
    s1024) as 2 worker processes on the card over `--num_ps 2 --ps_mode
    process` on shm, in window mode (W 4, bf16 EF, tasks of one window),
    32 steps: PS shard 1's process is SIGKILLed from outside once its
    stats show its 3rd applied push. The recovery plane relaunches the
    slot at generation 1 and seeds it from a worker's restore upload at
    the version floor; the torn window is replayed under its key.
    Checks rc 0 (every record completed), recoveries [("ps", 1, 1)],
    generations [0, 1], nothing unrecoverable, the seed version-exact,
    each shard's version and the master's at init + 32, 32 steps accepted
    (the retrained ones computed again: launches = layers x steps
    computed), no attention fallback, finite losses. Prints the
    recovery's seconds from the kill. Returns the launches summed over
    the workers."""
    from elasticdl_tpu_torch.worker.main import read_summaries

    name = "shard failover"
    data, logs = os.path.join(tmp, "failover-data"), os.path.join(tmp, "failover-logs")
    write_shards(data, FAILOVER_FILES)
    steps = FAILOVER_FILES * SHARD_RECORDS // BATCH
    argv = (master_argv(data, 2, os.path.join(tmp, "failover.ckpt"), SLICE_PARAMS, BATCH,
                        BATCH * WINDOW)
            + WINDOW_ARGS + ["--num_ps", "2", "--ps_mode", "process"])
    box = {}
    from elasticdl_tpu_torch.obs import flight, metrics

    flight.RECORDER.clear()
    events_before = recovery_event_counts(metrics, "ps")
    with tier_dir() as uds:
        rc, summary, wall = run_master(argv, logs, {"EDL_TRANSPORT": "shm", "EDL_UDS_DIR": uds},
                                       on_start=shard_killer("ps", 1, ps_pushes_applied(1, 3), box))
    with logs_on_failure(logs):
        workers = read_summaries(logs)
        failures = check_failover(summary, "ps", 1, box)
        ring = [e for e in flight.RECORDER.snapshot()
                if e.get("shard_kind") == "ps" and e.get("shard") == 1]
        kinds = [e["kind"] for e in ring]
        counted = {k: v - events_before.get(k, 0)
                   for k, v in recovery_event_counts(metrics, "ps").items()}
        if kinds != ["recovery_begin", "generation_bump", "recovery_done"]:
            failures.append(f"the flight ring's shard 1 events {kinds}: fence, relaunch, "
                            f"restore expected")
        if counted != {"begin": 1.0, "done": 1.0}:
            failures.append(f"edl_recovery_events_total moved by {counted}")
        if rc != 0 or summary is None:
            raise AssertionError(f"{name}: master.main exited {rc}\n" + "\n".join(failures))
        versions = [st["version"] for st in summary["ps_shards"]]
        failures += sharded_exactness(name, summary, steps)
        tl = (summary["recovery_timelines"] or [{}])[0]
        if not tl.get("exact"):
            failures.append(f"the restore was not version-exact: {tl}")
        new_shard = summary["ps_shards"][1]
        if new_shard["generation"] != 1 or new_shard["pid"] == box.get("pid"):
            failures.append(f"shard 1 after the job: {new_shard}")
        accepted = sum(s["steps_accepted"] for s in workers.values())
        if sorted(workers) != [0, 1] or accepted != steps:
            failures.append(f"workers {sorted(workers)} accepted {accepted} steps, {steps} expected")
        card = torch.cuda.get_device_name(0)
        n_layers = zoo_model(SLICE_PARAMS).cfg.n_layers
        for wid, s in sorted(workers.items()):
            n = n_layers * s["steps_computed"]
            want = want_launches(64, {"flash_forward": n, "flash_dq": n, "flash_dkv": n})
            if s["device"] != card or s["launches"] != want or s["attention_fallbacks"]:
                failures.append(f"worker {wid} on {s['device']}: launches {s['launches']}, "
                                f"{want} expected, fallbacks {s['attention_fallbacks']}")
            losses = [loss for _t, _n, loss in s["windows"]]
            if not losses or not all(math.isfinite(x) for x in losses):
                failures.append(f"worker {wid}: window losses {losses[:4]}... not all finite")
        if failures:
            raise AssertionError(f"{name}:\n" + "\n".join(failures))
        windows = [w for s in workers.values() for w in s["windows"]]
        print(f"{name} (2 PS shard processes, 2 workers, W {WINDOW}, b{BATCH}, {steps} steps, "
              f"shm; shard 1 SIGKILLed at its 3rd push): rc {rc} in {wall:.2f} s, recoveries "
              f"{summary['recoveries']}, generations {summary['generations']['ps']}, shard "
              f"versions {versions}, {window_steady(windows):.1f} tokens/s from the first to "
              f"the last window sync")
        print(f"{name}: flight ring {[(e['seq'], e['kind'], e.get('generation')) for e in ring]}"
              f", edl_recovery_events_total +{counted} (kind ps)")
        print(f"{name}: {failover_seconds(tl, box['kill'], new_shard['first_apply_at'])}; "
              f"the fence v{tl['fence_version']}, seeded at v{tl['restored_version']}, "
              f"optimizer state {'mirrored' if tl['opt_restored'] else 'cold'}")
        page_in_line(name, workers)
        for wid, s in sorted(workers.items()):
            print(f"{name} worker {wid}: {s['steps_accepted']} steps accepted, "
                  f"{s['steps_computed']} computed, {s['deduped_windows']} windows deduped, "
                  f"{s['shard_recoveries_observed']} recoveries waited out, "
                  f"{s['restore_uploads']} restore uploads taken, launches {s['launches']}")
        left = shard_processes(PS_SHARD_MAIN)
        segments = [n for n in os.listdir("/dev/shm") if n.startswith("edltshm.")]
        if left or segments:
            raise AssertionError(f"{name}: shard processes {left}, segments {segments} left")
        return summed_launches(workers)


# -- the fault-injection plane: the reference's chaos job on the card
CHAOS_FILES, CHAOS_RECORDS, CHAOS_TASK = 2, 32, 16  # 2 epochs: 16 pushes a shard, 8 tasks


def chaos_spec(once_file) -> dict:
    """The reference's chaos job spec (`tests/test_chaos.py:560-585`, all
    on the workers' clients), and one server-side entry on PS shard 1's
    process: its 2nd PSPull answers UNAVAILABLE (it shows that each shard
    slot carries its own chaos tags)."""
    return {"seed": 11, "faults": [
        {"kind": "latency", "methods": ["PSPull"], "roles": ["worker"], "latency_ms": 20,
         "every": 1, "max_fires": 4},
        {"kind": "error", "code": "UNAVAILABLE", "methods": ["PSPushGrad"],
         "roles": ["worker"], "every": 4, "max_fires": 3},
        {"kind": "drop", "methods": ["PSPushGrad"], "roles": ["worker"], "nth": 3},
        {"kind": "crash", "methods": ["GetTask"], "roles": ["worker"], "targets": ["0"],
         "nth": 2, "when": "after", "once_file": once_file},
        {"kind": "error", "code": "UNAVAILABLE", "methods": ["PSPull"], "side": "server",
         "roles": ["ps"], "targets": ["1"], "nth": 2},
    ]}


def shard_chaos_watcher(shard, box):
    """master.main's `on_start`: keep the servicer; hold every GetTask
    until workers 0 and 1 have both asked, and, once worker 0 has asked
    twice (the spec crashes it there), worker 1's until worker 0's
    replacement (worker 2) has asked too, 120 s at most each: otherwise a
    worker that boots late finds the job done, worker 0 might never ask
    twice, and the replacement might take no task and launch nothing.
    Then read PS shard `shard`'s `edl_chaos_injected_total` over
    GetMetrics until it shows an injected error (the shard processes are
    gone when the job returns)."""
    def on_start(servicer):
        from elasticdl_tpu_torch.rpc.client import RpcClient

        box["servicer"] = servicer
        dispatcher = servicer._task_d
        get, asked, cv = dispatcher.get, {}, threading.Condition()

        def gated(worker_id):
            with cv:
                asked[worker_id] = asked.get(worker_id, 0) + 1
                cv.notify_all()
                cv.wait_for(lambda: {0, 1} <= set(asked), timeout=120)
                if worker_id == 1 and asked.get(0, 0) >= 2:
                    cv.wait_for(lambda: 2 in asked, timeout=120)
            return get(worker_id)

        dispatcher.get = gated

        def watch():
            client = RpcClient(servicer.ps_group.endpoints[shard])
            deadline = time.monotonic() + 600
            try:
                while time.monotonic() < deadline:
                    try:
                        rows = client.call("GetMetrics", {}, timeout=10)["metrics"].get(
                            "edl_chaos_injected_total", [])
                    except Exception:  # noqa: BLE001 - a busy shard answers next time
                        rows = []
                    box["shard_faults"] = {r["labels"]["kind"]: r["value"] for r in rows}
                    if box["shard_faults"].get("error"):
                        return
                    time.sleep(0.05)
            finally:
                client.close()

        threading.Thread(target=watch, name=f"chaos-watch-ps{shard}", daemon=True).start()

    return on_start


def grep_count(log_dir, needle) -> int:
    count = 0
    for name in sorted(os.listdir(log_dir)):
        with open(os.path.join(log_dir, name), errors="replace") as f:
            count += f.read().count(needle)
    return count


def phase_chaos(tmp):
    """The reference's chaos job (`tests/test_chaos.py:465-532`) at the
    base transformer's width (d512, 8 heads of 64, 8 layers, bf16, b8 x
    s1024): 2 worker processes on the card over `--num_ps 2 --ps_mode
    process` on shm, per-step with `--grads_to_wait 1 --staleness_window
    1`, 2 files of 32 records for 2 epochs in tasks of 16 (16 pushes a
    shard, 8 tasks), under `EDL_CHAOS_SPEC=@file` (`chaos_spec`): 20 ms
    on the workers' first 4 PSPulls, UNAVAILABLE on every 4th PSPushGrad
    (3 at most), the 3rd PSPushGrad's response dropped after the shard
    applied it, worker 0 crashed (exit 117) right after its 2nd GetTask
    (once), and shard 1's process answering its 2nd PSPull UNAVAILABLE.
    Checks rc 0 with every record completed once, each shard at init + 16
    with 32 pushes applied, a dedup hit, a relaunch, the once file, each
    client-side kind in the worker logs and the server-side error in
    shard 1's GetMetrics, finite losses, and each worker that wrote a
    summary (the crashed one writes none) on the card with steps
    computed, launches n_layers x steps computed of all three kernels and
    no fallback. No fault-free twin here: the shards' versions are held
    to init + pushes (the CPU tests run the twin). Returns the launches
    summed over the workers that wrote a summary."""
    from elasticdl_tpu_torch.common.constants import ENV_CHAOS_SPEC
    from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
    from elasticdl_tpu_torch.worker.main import read_summaries

    name = "chaos"
    t0 = time.perf_counter()
    root = os.path.join(tmp, "chaos")
    data, logs = os.path.join(root, "data"), os.path.join(root, "logs")
    os.makedirs(data)
    for i in range(CHAOS_FILES):
        write_learnable_token_records(os.path.join(data, f"shard-{i}.rio"), CHAOS_RECORDS,
                                      SEQ, SLICE["vocab"], seed=i)
    once = os.path.join(root, "crash.once")
    spec_path = os.path.join(root, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(chaos_spec(once), f)
    epochs, records = 2, CHAOS_FILES * CHAOS_RECORDS
    steps = epochs * records // BATCH
    argv = master_argv(data, 2, os.path.join(root, "final.ckpt"), SLICE_PARAMS, BATCH,
                       CHAOS_TASK)
    argv[argv.index("--num_epochs") + 1] = str(epochs)
    argv += ["--staleness_window", "1", "--num_ps", "2", "--ps_mode", "process"]
    box = {}
    with tier_dir() as uds:
        rc, summary, wall = run_master(
            argv, logs, {"EDL_TRANSPORT": "shm", "EDL_UDS_DIR": uds,
                         ENV_CHAOS_SPEC: f"@{spec_path}"},
            on_start=shard_chaos_watcher(1, box))
    with logs_on_failure(logs):
        if rc != 0 or summary is None:
            raise AssertionError(f"{name}: master.main exited {rc}")
        workers = read_summaries(logs)
        failures = sharded_exactness(name, summary, steps)
        shards = summary["ps_shards"]
        completed = box["servicer"]._task_d.completed_records()
        applied = sum(st["applied_pushes"] for st in shards)
        dups = sum(st["duplicate_pushes"] for st in shards)
        if completed != epochs * records:
            failures.append(f"{completed} records completed, {epochs * records} expected")
        if applied != len(shards) * steps or dups < 1:
            failures.append(f"{applied} pushes applied ({len(shards) * steps} expected), "
                            f"{dups} deduped (1 at least expected)")
        if summary["relaunches"] < 1 or not os.path.exists(once):
            failures.append(f"relaunches {summary['relaunches']}, once file "
                            f"{os.path.exists(once)}: the crash was not ridden out")
        seen = {kind: grep_count(logs, needle) for kind, needle in (
            ("latency", "chaos: +20ms latency"), ("error", "chaos: injecting UNAVAILABLE"),
            ("drop", "chaos: dropping response"), ("crash", "chaos: crashing process"))}
        if min(seen.values()) < 1 or seen["crash"] != 1:
            failures.append(f"the worker logs' chaos lines {seen}: each kind, one crash expected")
        shard_faults = box.get("shard_faults", {})
        if shard_faults.get("error", 0) < 1:
            failures.append(f"shard 1's edl_chaos_injected_total {shard_faults}: an error "
                            "expected")
        card = torch.cuda.get_device_name(0)
        n_layers = zoo_model(SLICE_PARAMS).cfg.n_layers
        computed = sum(s["steps_computed"] for s in workers.values())
        # the crashed worker writes no summary: its steps are not counted
        if not 0 < computed <= steps:
            failures.append(f"workers {sorted(workers)} computed {computed} steps of {steps}")
        for wid, s in sorted(workers.items()):
            n = n_layers * s["steps_computed"]
            want = want_launches(64, {"flash_forward": n, "flash_dq": n, "flash_dkv": n})
            if (s["device"] != card or not s["steps_computed"] or s["launches"] != want
                    or s["attention_fallbacks"]):
                failures.append(f"worker {wid} on {s['device']}: {s['steps_computed']} steps, "
                                f"launches {s['launches']}, {want} expected, fallbacks "
                                f"{s['attention_fallbacks']}")
            if not all(math.isfinite(x) for x in s["losses"]):
                failures.append(f"worker {wid}: losses {s['losses'][:4]}... not all finite")
        if failures:
            raise AssertionError(f"{name}:\n" + "\n".join(failures))
        versions = [st["version"] for st in shards]
        print(f"chaos: base transformer, 2 worker processes over 2 PS shard processes on shm, "
              f"b{BATCH}, {steps} pushes a shard: rc {rc} in {wall:.2f} s (phase "
              f"{time.perf_counter() - t0:.2f} s); shard versions {versions}, {applied} pushes "
              f"applied, {dups} deduped, {completed} records completed, {summary['relaunches']} "
              f"relaunches; worker log lines {seen}; shard 1 injected {shard_faults}; workers "
              + ", ".join(f"{wid}: {s['steps_computed']} steps, launches {s['launches']}"
                          for wid, s in sorted(workers.items())))
        return summed_launches(workers)


# -- the observability plane ------------------------------------------------------

OBS_STEPS = 32  # the in-process window job's steps: 8 windows of W 4
OBS_FILES = 2  # of SHARD_RECORDS: 16 window steps over 2 worker processes
# the flash kernels as a CUDA kernel event of a torch.profiler trace names them
TRACE_KERNELS = {"flash_forward": "fa_fwd_bf16_kernel", "flash_dq": "fa_dq_bf16_kernel",
                 "flash_dkv": "fa_dkv_bf16_kernel"}


def obs_window_run(fa, tmp, name, steps):
    """The base window job (W 4, bf16 EF, grads_to_wait 1) in process,
    its worker on the card talking to the master's server over the TCP
    tier, as the reference's traced bench job runs. Returns (tokens/s
    from the first to the last window sync, wall seconds of the run,
    launches, fallbacks, the worker)."""
    from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.models import transformer_lm_zoo as zoo
    from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
    from elasticdl_tpu_torch.rpc.client import RpcClient
    from elasticdl_tpu_torch.rpc.server import RpcServer
    from elasticdl_tpu_torch.testing import build_job
    from elasticdl_tpu_torch.worker.worker import Worker

    path = os.path.join(tmp, f"{name}.rio")
    write_learnable_token_records(path, BATCH * steps, SEQ, SLICE["vocab"], seed=0)
    dispatcher = TaskDispatcher({path: BATCH * steps}, {}, {}, BATCH * WINDOW, 1, shuffle_seed=0)
    spec = spec_from_module(zoo, model=zoo.custom_model(**SLICE, dtype=torch.bfloat16))
    servicer, _eval, _ckpt = build_job(spec, dispatcher, grads_to_wait=1)
    server = RpcServer(servicer.handlers(), port=0)
    server.start()
    client = RpcClient(f"localhost:{server.port}")
    try:
        worker = Worker(0, client, spec, minibatch_size=BATCH, device="cuda", seed=0,
                        local_updates=WINDOW, sync_dtype="bfloat16")
        reset_counts(fa)
        t0 = time.perf_counter()
        ok = worker.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, fallbacks = read_counts(fa)
        worker.close()
    finally:
        client.close()
        server.stop()
    ex = servicer.exactness()
    if not ok or not dispatcher.finished() or ex["applied_update_steps"] != steps:
        raise AssertionError(f"{name}: the window job did not finish exactly: {ex}")
    losses = [loss for _t, _n, loss in worker.window_log]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: window losses {losses} not all finite")
    want = want_launches(64, dict.fromkeys(KERNELS, SLICE["n_layers"] * steps))
    if launches != want or fallbacks:
        raise AssertionError(f"{name}: launches {launches}, {want} expected, fallbacks "
                             f"{fallbacks}")
    return window_steady(worker.window_log), wall, launches, fallbacks, worker


def phase_obs_critical_path(fa, tmp):
    """The span-derived sync critical path of the base transformer's
    window job at full width (d512, 8 heads of 64, 8 layers, bf16, b8 x
    s1024; W 4, bf16 EF, grads_to_wait 1: the reference's traced bench
    job), run in process with EDL_TRACE_SAMPLE at 1 and the recorder
    cleared: `sync_critical_path_from_spans` must find the chain and its
    components must re-compose the span-measured sync wall within 10%
    (the reference's own gate); prints the components and the exposed
    sync fraction. Then the same job with tracing off: both tokens/s.
    Launches are the path's D = 64 counts, with 0 fallbacks, in both.
    Returns the traced run's launches."""
    from elasticdl_tpu_torch.obs import trace
    from elasticdl_tpu_torch.obs.critical_path import (
        sync_critical_path_from_spans,
        sync_exposed_fraction_from_spans,
    )

    name = "obs critical path"
    trace.configure(1.0)
    trace.RECORDER.clear()
    try:
        traced_rate, wall, launches, _f, worker = obs_window_run(fa, tmp, "obs-traced", OBS_STEPS)
        spans = trace.RECORDER.snapshot()
        dropped = trace.RECORDER.dropped
    finally:
        trace.configure(0.0)
    try:
        plain_rate, _w, _l, _f, _worker = obs_window_run(fa, tmp, "obs-untraced", OBS_STEPS)
        if len(trace.RECORDER) != len(spans):
            raise AssertionError(f"{name}: the untraced run recorded spans")
    finally:
        trace.configure(None)
        trace.RECORDER.clear()
    cp = sync_critical_path_from_spans(spans, sync_method="ReportLocalUpdate")
    if cp is None:
        raise AssertionError(f"{name}: no worker.window_sync spans in {len(spans)} spans")
    frac = cp["sum_fraction"]
    exposed = sync_exposed_fraction_from_spans(spans, wall)
    print(f"{name} (base W {WINDOW} bf16, {OBS_STEPS} steps, tcp, EDL_TRACE_SAMPLE=1): "
          f"{cp['rounds']} rounds, sync_wait {cp['sync_wait_s']} s = encode {cp['encode_s']} + "
          f"queue_wait {cp['queue_wait_s']} + apply {cp['apply_s']} + wire {cp['wire_s']} + "
          f"serve_other {cp['serve_other_s']} s (combine {cp['combine_s']}), sum_fraction "
          f"{frac}; {len(spans)} spans, {dropped} dropped")
    print(f"{name}: sync_exposed_fraction {exposed['sync_exposed_fraction']} of "
          f"{exposed['total_wall_s']} s ({exposed['stalls']} stalls, by reason "
          f"{exposed['by_reason']}); worker phases {rounded(worker.phase_seconds)}")
    print(f"{name}: traced {traced_rate:.1f} tokens/s, untraced {plain_rate:.1f} tokens/s "
          f"(same job, this call; ratio {traced_rate / plain_rate:.3f})")
    if frac is None or not 0.9 <= frac <= 1.1:
        raise AssertionError(f"{name}: the components sum to {frac} of the sync wall, "
                             f"[0.9, 1.1] expected: {cp}")
    return launches


def trace_kernel_counts(path) -> dict:
    """{kernel: CUDA kernel events} of a torch.profiler Chrome trace, for
    the three flash kernels."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(1 for n in names if sym in n) for k, sym in TRACE_KERNELS.items()}


def phase_obs_processes(tmp):
    """The base transformer in window mode (W 4, bf16 EF) as 2 worker
    processes on the card over `--num_ps 2 --ps_mode process`, with
    EDL_TRACE_SAMPLE=1 in every process, EDL_SCHED_PHASE_SECS 0.25 and
    `--profile_dir`, 16 steps. When the job's last task is reported, and
    before it ends (the check runs inside the dispatcher's `finished`),
    the master's GetTrace and each shard's are merged into one Chrome
    trace (a trace id must show in spans of two or more processes), and
    the master's GetMetrics read: each shard's
    `edl_ps_applied_pushes_total` must equal the windows the workers
    landed, and `edl_phase_seconds_total` must carry each worker. After
    the job each worker's torch.profiler trace must name the three flash
    kernels, its forward kernel events equal to its summary's forward
    launches. Returns the launches summed over the workers."""
    from elasticdl_tpu_torch.obs import fetch, trace
    from elasticdl_tpu_torch.rpc.client import RpcClient
    from elasticdl_tpu_torch.worker.main import read_summaries

    name = "obs processes"
    data, logs = os.path.join(tmp, "obs-data"), os.path.join(tmp, "obs-logs")
    profile = os.path.join(tmp, "obs-profile")
    merged_path = os.path.join(tmp, "obs-merged-trace.json")
    write_shards(data, OBS_FILES)
    steps = OBS_FILES * SHARD_RECORDS // BATCH
    argv = (master_argv(data, 2, os.path.join(tmp, "obs.ckpt"), SLICE_PARAMS, BATCH,
                        BATCH * WINDOW)
            + WINDOW_ARGS + ["--num_ps", "2", "--ps_mode", "process", "--profile_dir", profile])
    seen = {}

    def scrape(servicer):
        group = servicer.ps_group
        clients = [RpcClient(ep) for ep in group.endpoints]
        try:
            merged = fetch.fetch_chrome_trace(clients, path=merged_path)
            seen["shard_traces"] = [len(fetch.fetch_trace(c)["spans"]) for c in clients]
        finally:
            for c in clients:
                c.close()
        seen["master_spans"] = len(servicer.handlers()["GetTrace"]({})["spans"])
        seen["events"] = merged["traceEvents"]
        seen["dropped"] = merged["otherData"]["dropped_spans"]
        seen["metrics"] = servicer.handlers()["GetMetrics"]({})

    def on_start(servicer):
        dispatcher = servicer._task_d
        finished, lock = dispatcher.finished, threading.Lock()

        def finished_then_scrape():
            done = finished()
            if done:
                with lock:
                    if "metrics" not in seen and "error" not in seen:
                        try:
                            scrape(servicer)
                        except Exception as e:  # checked after the job
                            seen["error"] = repr(e)
            return done

        dispatcher.finished = finished_then_scrape

    env = {"EDL_TRANSPORT": "shm", "EDL_TRACE_SAMPLE": "1", "EDL_SCHED_PHASE_SECS": "0.25"}
    trace.RECORDER.clear()
    try:
        with tier_dir() as uds:
            trace.configure(1.0)
            rc, summary, wall = run_master(argv, logs, dict(env, EDL_UDS_DIR=uds),
                                           on_start=on_start)
    finally:
        trace.configure(None)
        trace.RECORDER.clear()
    with logs_on_failure(logs):
        workers = read_summaries(logs)
        if rc != 0 or summary is None or "error" in seen or "metrics" not in seen:
            raise AssertionError(f"{name}: master.main exited {rc}; scrape "
                                 f"{seen.get('error', 'never ran')}")
        failures = []
        by_trace = {}
        for e in seen["events"]:
            by_trace.setdefault(e["args"]["trace_id"], set()).add(e["pid"])
        shared = {t: pids for t, pids in by_trace.items() if len(pids) >= 2}
        if not shared:
            failures.append(f"no trace id in spans of two processes ({len(by_trace)} traces)")
        if not os.path.exists(merged_path):
            failures.append("the merged Chrome trace was not written")
        landed = sum(len(s["windows"]) for s in workers.values())
        shards = seen["metrics"]["shards"]
        applied = [sum(r["value"] for r in shards.get(f"ps{i}", {}).get(
            "edl_ps_applied_pushes_total", [])) for i in range(2)]
        if applied != [landed, landed]:
            failures.append(f"shards applied {applied} pushes, the workers landed {landed}")
        phase_rows = seen["metrics"]["metrics"].get("edl_phase_seconds_total", [])
        phase_workers = sorted({r["labels"]["worker"] for r in phase_rows})
        if phase_workers != ["0", "1"]:
            failures.append(f"edl_phase_seconds_total carries workers {phase_workers}")
        n_layers = zoo_model(SLICE_PARAMS).cfg.n_layers
        card = torch.cuda.get_device_name(0)
        accepted = sum(s["steps_accepted"] for s in workers.values())
        if sorted(workers) != [0, 1] or accepted != steps:
            failures.append(f"workers {sorted(workers)} accepted {accepted}, {steps} expected")
        traced = {}
        for wid, s in sorted(workers.items()):
            n = n_layers * s["steps_computed"]
            want = want_launches(64, dict.fromkeys(KERNELS, n))
            if s["device"] != card or s["launches"] != want or s["attention_fallbacks"]:
                failures.append(f"worker {wid} on {s['device']}: launches {s['launches']}, "
                                f"{want} expected, fallbacks {s['attention_fallbacks']}")
            path = s.get("profile_trace")
            if not path or not os.path.exists(path) or os.path.dirname(path) != os.path.join(
                    profile, f"worker-{wid}"):
                failures.append(f"worker {wid}: profiler trace {path!r} missing")
                continue
            traced[wid] = trace_kernel_counts(path)
            if not all(traced[wid].values()):
                failures.append(f"worker {wid}: the trace's flash kernels {traced[wid]}")
            if traced[wid]["flash_forward"] != s["launches"]["flash_forward_d64"]:
                failures.append(f"worker {wid}: {traced[wid]['flash_forward']} forward kernels "
                                f"traced, {s['launches']['flash_forward_d64']} launched")
        if failures:
            raise AssertionError(f"{name}:\n" + "\n".join(failures))
        # an example: a window's trace, when one spans processes
        trace_id = next((t for t in shared if any(
            e["name"] == "ps.apply" and e["args"]["trace_id"] == t for e in seen["events"])),
            next(iter(shared)))
        pids = shared[trace_id]
        names = sorted({e["name"] for e in seen["events"] if e["args"]["trace_id"] == trace_id})
        print(f"{name} (2 PS shard processes, 2 workers, W {WINDOW}, b{BATCH}, {steps} steps, "
              f"shm, every process traced): rc {rc} in {wall:.2f} s; merged trace "
              f"{len(seen['events'])} spans (master {seen['master_spans']}, shards "
              f"{seen['shard_traces']}, {seen['dropped']} dropped), {len(shared)} of "
              f"{len(by_trace)} trace ids in two or more processes, e.g. {trace_id} in pids "
              f"{sorted(pids)}: {names}")
        print(f"{name}: shard applied pushes {applied} = the workers' {landed} landed windows; "
              f"edl_phase_seconds_total for workers {phase_workers}: " + ", ".join(
                  f"{r['labels']['worker']}/{r['labels']['phase']} {r['value']:.3f}"
                  for r in sorted(phase_rows, key=lambda r: (r["labels"]["worker"],
                                                             r["labels"]["phase"]))))
        for wid, s in sorted(workers.items()):
            print(f"{name} worker {wid}: torch.profiler trace {s['profile_trace']} "
                  f"({os.path.getsize(s['profile_trace'])} bytes): CUDA kernel events "
                  f"{traced[wid]}, summary launches {s['launches']['flash_forward_d64']} / "
                  f"{s['launches']['flash_dq_d64']} / {s['launches']['flash_dkv_d64']}; "
                  f"phase seconds {rounded(s['phase_seconds'])}")
        windows = [w for s in workers.values() for w in s["windows"]]
        print(f"{name}: {window_steady(windows):.1f} tokens/s from the first to the last "
              f"window sync (traced and profiled)")
        left = shard_processes(PS_SHARD_MAIN)
        if left:
            raise AssertionError(f"{name}: shard processes {left} left")
        return summed_launches(workers)


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
    _spec, dispatcher, servicer, _eval, _ckpt = build_master(args)
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


# -- the image zoo ------------------------------------------------------------


def image_spec(model_def, model_params=""):
    """The port's image model through its entry point (`get_model_spec`
    over the port's zoo, as `--model_def` and `--model_params` give it)."""
    from elasticdl_tpu_torch.api.model_spec import get_model_spec

    return get_model_spec(ZOO, model_def, model_params)


def image_job(path, model_def, batch, n_records, task_records, model_params="", **worker_kw):
    """An in-process master/PS and one worker on the card over `n_records`
    synthetic image records (seed 0, the reference's writer) of the
    model's IMAGE_SHAPE, in tasks of `task_records`; `worker_kw` selects
    window mode."""
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.models.record_codec import write_synthetic_image_records
    from elasticdl_tpu_torch.testing import InProcessMaster, build_job
    from elasticdl_tpu_torch.worker.worker import Worker

    spec = image_spec(model_def, model_params)
    if not os.path.exists(path):
        write_synthetic_image_records(path, n_records, spec.module.IMAGE_SHAPE,
                                      spec.module.NUM_CLASSES, seed=0)
    dispatcher = TaskDispatcher({path: n_records}, {}, {}, task_records, 1, shuffle_seed=0)
    servicer, _eval, _ckpt = build_job(spec, dispatcher, grads_to_wait=1)
    master = InProcessMaster(servicer)
    worker = Worker(0, master, spec, minibatch_size=batch, device="cuda", seed=0, **worker_kw)
    return dispatcher, servicer, master, worker, spec.model


def check_aux(aux, model, what):
    """The PS's batch statistics: finite and moved from flax's init."""
    from elasticdl_tpu_torch.common import codec

    init = model.init_aux()
    if not init:
        if aux:
            raise AssertionError(f"{what}: aux {list(aux)} for a model without any")
        return
    flat, flat0 = codec.ravel_np(aux), codec.ravel_np(init)
    if codec.tree_paths(aux) != codec.tree_paths(init) or not np.isfinite(flat).all():
        raise AssertionError(f"{what}: the PS's aux is not the model's tree of finite values")
    if np.array_equal(flat, flat0):
        raise AssertionError(f"{what}: the PS's batch statistics did not move from init")


def run_image_job(fa, what, job, steps):
    """Runs an in-process image job with the launch counts at 0 just
    before and read just after, and holds it to the checks of every image
    run: a clean finish, the exactness block with every step applied once,
    steps computed = applied, finite losses, parameters finite and moved,
    the PS's batch statistics finite and moved, and no attention launch or
    fallback (the image models run no attention). Returns (wall seconds,
    worker, servicer, master)."""
    from elasticdl_tpu_torch.common import codec

    dispatcher, servicer, master, worker, model = job
    reset_counts(fa)
    t0 = time.perf_counter()
    ok = worker.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fallbacks = read_counts(fa)
    worker.close()
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
    if any(launches.values()) or fallbacks:
        raise AssertionError(f"{what}: attention launches {launches}, fallbacks {fallbacks}; "
                             f"an image model runs none")
    params, aux, _v = servicer.get_params_copy()
    flat = codec.ravel_np(params)
    if not np.isfinite(flat).all() or np.array_equal(flat, codec.ravel_np(model.init_params(0))):
        raise AssertionError(f"{what}: the parameters are not finite or did not move")
    check_aux(aux, model, what)
    print(f"{what}: {steps} steps, exactness {ex}, attention launches "
          f"{sum(launches.values())}, fallbacks {fallbacks}")
    return wall, worker, servicer, master


# (model def, --model_params) of each model phase_image_models holds on the
# card against the CPU: the five models, ResNet-50 also in bf16
IMAGE_MODELS = (
    ("mnist_functional_api.custom_model", ""),
    ("mnist_subclass.custom_model", ""),
    ("cifar10_functional_api.custom_model", ""),
    ("cifar10_subclass.custom_model", ""),
    ("resnet50_subclass.custom_model", ""),
    ("resnet50_subclass.custom_model", "bfloat16=True"),
)
IMAGE_CHECK_BATCH = 16
# card vs CPU, norm-relative (|card - cpu| / |cpu| over the whole output).
# float32 (TF32 off on both) differs in the convolutions' algorithms and
# summation orders: logits and stats 1e-6 to 2e-6 of their norm. The
# gradient may also differ where a relu's input sits within float32
# rounding of zero: ResNet-50's first stage holds one element at 7.4e-7
# (float64) that the card rounds to <= 0 and the CPU does not, which
# routes that element's gradient elsewhere and moves the whole gradient
# by 1.9e-4 (both are within 1.7e-6 of float64 everywhere else); hence
# 1e-3 for the gradient. bf16 also differs in where each backend rounds
# inside its convolutions, which a BatchNorm over 16 x 2 x 2 values
# amplifies (the port's CPU test holds bf16 ResNet to flax's bf16 at
# 0.03 / 0.3 / 1e-3)
IMAGE_TOL = {"float32": {"logits": 1e-4, "grad": 1e-3, "batch_stats": 1e-4},
             "bfloat16": {"logits": 0.03, "grad": 0.3, "batch_stats": 1e-3}}


def image_step(model, params, aux, x, y, device):
    """One train-mode forward and backward of `model` on `device` from the
    host trees: (logits, flat gradient, new batch stats) as float64 numpy."""
    from elasticdl_tpu_torch.api.model_spec import new_aux_values, takes_train_kwarg
    from elasticdl_tpu_torch.common import codec
    from elasticdl_tpu_torch.convert import load_variables

    model = model.to(device)
    load_variables(model, params, aux)
    names = [".".join(p) for p in codec.tree_paths(params)]
    xt, yt = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    out = model(xt, train=True) if takes_train_kwarg(model) else model(xt)
    loss = torch.nn.functional.cross_entropy(out.float(), yt)
    grads = torch.autograd.grad(loss, [model.get_parameter(n) for n in names])
    new = new_aux_values(model, codec.tree_paths(aux)) if aux else []
    as_np = lambda ts: torch.cat([t.reshape(-1).double().cpu() for t in ts]).numpy()  # noqa: E731
    return as_np([out.detach()]), as_np(grads), as_np(new) if new else np.zeros(0)


def phase_image_models():
    """Each image model (the five, ResNet-50 also in bf16) runs one
    train-mode forward and backward on the card and on the CPU, from the
    same host init (BatchNorm statistics moved off init) and the same
    uint8 batch of IMAGE_CHECK_BATCH at the model's IMAGE_SHAPE; the
    logits, the gradient and the new batch stats are held to IMAGE_TOL."""
    from elasticdl_tpu_torch.common import codec

    failures = []
    for model_def, model_params in IMAGE_MODELS:
        spec = image_spec(model_def, model_params)
        rng = np.random.default_rng(0)
        shape = spec.module.IMAGE_SHAPE
        x = rng.integers(0, 256, (IMAGE_CHECK_BATCH,) + shape).astype(np.uint8)
        y = rng.integers(0, spec.module.NUM_CLASSES, IMAGE_CHECK_BATCH)
        params = spec.model.init_params(0)
        # running statistics off their init, as a trained model has them
        aux = codec.tree_map(lambda a: (a + rng.uniform(-0.5, 0.5, a.shape)).astype(np.float32),
                             spec.model.init_aux())
        dtype = "bfloat16" if "bfloat16" in model_params else "float32"
        t0 = time.perf_counter()
        card = image_step(spec.model, params, aux, x, y, "cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = image_step(image_spec(model_def, model_params).model, params, aux, x, y, "cpu")
        cpu_s = time.perf_counter() - t0
        errs = {}
        for what, got, want in zip(("logits", "grad", "batch_stats"), card, cpu):
            if not want.size:
                continue
            errs[what] = float(np.linalg.norm(got - want) / np.linalg.norm(want))
            if not np.isfinite(got).all() or not errs[what] <= IMAGE_TOL[dtype][what]:
                failures.append(f"{model_def} {model_params!r} {what}: card vs CPU "
                                f"{errs[what]:.3e} (limit {IMAGE_TOL[dtype][what]:.0e})")
        print(f"image model {model_def} {model_params!r} ({dtype}, {shape}, batch "
              f"{IMAGE_CHECK_BATCH}, {card[1].size:,} params): card vs CPU norm-relative "
              + ", ".join(f"{w} {e:.3e} (limit {IMAGE_TOL[dtype][w]:.0e})" for w, e in errs.items())
              + f"; card {card_s:.2f} s (first call), CPU {cpu_s:.2f} s")
    if failures:
        raise AssertionError("the image models disagree between the card and the CPU:\n"
                             + "\n".join(failures))


def images_per_s(times, per_step) -> float:
    """Images/s between the first and the last of `times` (perf_counter),
    `per_step` images for each step after the first."""
    return (len(times) - 1) * per_step / (times[-1] - times[0])


def phase_image_per_step(fa, tmp):
    """Per-step runs through the in-process master/PS: cifar10_functional_api
    (minibatch 128, 64 updates) and mnist_functional_api (minibatch 64, 32
    updates); each prints images/s and the host PS apply's seconds a step
    (the ReportGradient handler: the f32 average, the zoo's SGD-momentum
    optimizer on the host, the model's ravel)."""
    for model_def, batch, steps in (("cifar10_functional_api.custom_model", 128, 64),
                                    ("mnist_functional_api.custom_model", 64, 32)):
        name = model_def.split(".")[0]
        job = image_job(os.path.join(tmp, f"{name}-per-step.rio"), model_def, batch,
                        batch * steps, batch * 8)
        wall, worker, _servicer, master = run_image_job(fa, f"{name} per-step", job, steps)
        times = [t for t, _loss in worker.step_log]
        print(f"{name} per-step (minibatch {batch}): {steps * batch / wall:.1f} images/s over "
              f"the whole run ({wall:.2f} s incl. model init), "
              f"{images_per_s(times, batch):.1f} images/s over steps 2-{steps}; host PS apply "
              f"(ReportGradient handler) {master.handler_seconds['ReportGradient'] / steps:.4f} "
              f"s a step; losses first / last {worker.step_log[0][1]:.4f} / "
              f"{worker.step_log[-1][1]:.4f}; worker phases {rounded(worker.phase_seconds)}, "
              f"wire codec {rounded(master.codec_seconds)}")


# the reference's headline job (bench.py:360-432) at its chip shape
CIFAR_WINDOW, CIFAR_BATCH, CIFAR_RECORDS = 32, 128, 65536
CIFAR_TASK_RECORDS = CIFAR_WINDOW * CIFAR_BATCH
CIFAR_GATE = 1.5  # the median of the last 3 task losses, bench.py:453
# 2 tasks (cut from 3 for the shard recovery phases' room)
CIFAR_PROFILE_RECORDS = 2 * CIFAR_TASK_RECORDS


def window_images_per_s(window_log, batch) -> float:
    """Images/s from the first to the last window sync that landed."""
    log = sorted(window_log)
    return sum(n for _t, n, _l in log[1:]) * batch / (log[-1][0] - log[0][0])


def phase_cifar_window(fa, tmp):
    """The headline job: cifar10_functional_api in window mode in-process,
    W 32, minibatch 128, 65,536 synthetic 32x32x3 records (seed 0) in
    tasks of 4,096, one epoch, bf16 error-feedback deltas. Checks the
    exactness block, the reference's convergence gate (the median of the
    last 3 task losses < 1.5), that the PS's batch_stats moved from init
    and equal the last synced window's, and 0 attention launches; prints
    steady and overall images/s. Then a profiled second run of 3 tasks
    gives the device idle share."""
    from elasticdl_tpu_torch.common import codec

    path = os.path.join(tmp, "cifar-headline.rio")
    steps = CIFAR_RECORDS // CIFAR_BATCH
    synced = []
    t0 = time.perf_counter()
    job = image_job(path, "cifar10_functional_api.custom_model", CIFAR_BATCH, CIFAR_RECORDS,
                    CIFAR_TASK_RECORDS, local_updates=CIFAR_WINDOW, sync_dtype="bfloat16")
    print(f"headline: {CIFAR_RECORDS} records written and the job built in "
          f"{time.perf_counter() - t0:.2f} s")
    master = job[2]
    call = master.call

    def recording_call(method, request=None):
        if method == "ReportLocalUpdate" and request.get("aux_state") is not None:
            synced.append(codec.ravel_np(request["aux_state"]))
        return call(method, request)

    master.call = recording_call
    wall, worker, servicer, master = run_image_job(fa, "headline cifar10 window", job, steps)
    losses = list(worker.task_losses)
    tail = statistics.median(losses[-3:])
    _params, aux, _v = servicer.get_params_copy()
    windows = list(worker.window_log)
    print(f"headline cifar10_functional_api window job (W {CIFAR_WINDOW}, minibatch "
          f"{CIFAR_BATCH}, {CIFAR_RECORDS} records, bf16 EF deltas): {len(windows)} syncs of "
          f"{sorted({n for _t, n, _l in windows})} steps, task losses "
          f"{[round(x, 4) for x in losses]}, last-3 median {tail:.4f} (gate < {CIFAR_GATE})")
    print(f"headline throughput: {CIFAR_RECORDS / wall:.1f} images/s over the whole run "
          f"({wall:.2f} s incl. model init), {window_images_per_s(windows, CIFAR_BATCH):.1f} "
          f"images/s from the first to the last window sync; sync seconds per sync: "
          + ", ".join(f"{k} {v / len(windows):.4f}" for k, v in sorted(worker.sync_seconds.items()))
          + f"; PS add a window {master.handler_seconds['ReportLocalUpdate'] / len(windows):.4f}"
          f" s; worker phases {rounded(worker.phase_seconds)}")
    if not tail < CIFAR_GATE:
        raise AssertionError(f"the headline job did not converge: last-3 median {tail:.3f}")
    if not synced or codec.ravel_np(aux).tobytes() != synced[-1].tobytes():
        raise AssertionError("the PS's batch_stats are not the last synced window's")
    del job, worker, servicer, master

    # the device idle share: a second run of 3 tasks under the profiler,
    # over the last two thirds of the device timeline (the first window
    # holds the warm-up)
    from torch.profiler import ProfilerActivity, profile

    *_rest, worker, _model = image_job(
        path, "cifar10_functional_api.custom_model", CIFAR_BATCH, CIFAR_PROFILE_RECORDS,
        CIFAR_TASK_RECORDS, local_updates=CIFAR_WINDOW, sync_dtype="bfloat16")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        worker.run()
        torch.cuda.synchronize()
    worker.close()
    device = [(e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and "Sync" not in e.name]
    if not device:
        print("headline profile: the profiler recorded no device time (not measured)")
        return
    first, last = min(s for s, _e in device), max(e for _s, e in device)
    t0 = first + (last - first) / 3
    busy = busy_us(device, t0, last)
    prof_steps = (CIFAR_PROFILE_RECORDS // CIFAR_BATCH) * 2 / 3
    print(f"headline profile: device busy {busy / 1e3 / prof_steps:.3f} ms per step (union of "
          f"kernels and copies on all streams) of {(last - t0) / 1e3 / prof_steps:.3f} ms per "
          f"step over the last two thirds of {CIFAR_PROFILE_RECORDS // CIFAR_BATCH} steps on the "
          f"device clock under the profiler (device idle share {1 - busy / (last - t0):.3f})")
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x  {e.key[:90]}")


# ResNet-50 in window mode at bench_resnet.py:123-160's runtime shape
# (records cut from 32,768, then 16,384: ResNet-50 also trains in the imagenet
# and churn jobs)
RESNET_WINDOW, RESNET_BATCH, RESNET_RECORDS = 32, 128, 8192


def phase_resnet_window(fa, tmp):
    """ResNet-50 (`custom_model(bfloat16=True)`: bf16 compute over f32
    parameters and statistics) in window mode in-process at 64 x 64, W 32,
    minibatch 128, `transport_dtype="bfloat16"`, 8,192 records in tasks
    of 4,096, one epoch. Prints images/s and the peak device memory of the
    run (parameters, the window's optimizer and sync state, and one
    step's activations at a time)."""
    steps = RESNET_RECORDS // RESNET_BATCH
    job = image_job(os.path.join(tmp, "resnet.rio"), "resnet50_subclass.custom_model",
                    RESNET_BATCH, RESNET_RECORDS, RESNET_WINDOW * RESNET_BATCH,
                    model_params="bfloat16=True", local_updates=RESNET_WINDOW,
                    transport_dtype="bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wall, worker, _servicer, master = run_image_job(fa, "resnet50 window", job, steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    windows = list(worker.window_log)
    print(f"resnet50 window (bf16, 64x64, W {RESNET_WINDOW}, minibatch {RESNET_BATCH}, "
          f"{RESNET_RECORDS} records, bf16 transport): {RESNET_RECORDS / wall:.1f} images/s over "
          f"the whole run ({wall:.2f} s incl. model init), "
          f"{window_images_per_s(windows, RESNET_BATCH):.1f} images/s from the first to the last "
          f"window sync; task losses {[round(x, 4) for x in worker.task_losses]}; peak device "
          f"memory {peak:.2f} GiB; sync seconds per sync: "
          + ", ".join(f"{k} {v / len(windows):.4f}" for k, v in sorted(worker.sync_seconds.items()))
          + f"; PS add a window {master.handler_seconds['ReportLocalUpdate'] / len(windows):.4f} s")


def phase_image_process_job(tmp):
    """`python -m elasticdl_tpu_torch.master.main --model_def
    cifar10_functional_api.custom_model --worker_backend process` (the
    port's zoo by default) with 2 workers on the card, per-step,
    minibatch 128, 2 shards of 1,024 records (16 updates): exit 0, the
    `--output` version = the steps, the exactness block, each worker on
    the card with no attention launch, the batch stats back through each
    worker's GetModel frames (`aux_absorbed`, by RPC; the ReportGradient
    piggybacks are printed), the final model's parameters and batch stats
    finite and moved."""
    from elasticdl_tpu_torch.common import codec
    from elasticdl_tpu_torch.common.constants import ENV_WORKER_LOG_DIR
    from elasticdl_tpu_torch.master import main as master_main
    from elasticdl_tpu_torch.master.checkpoint import load_model_file
    from elasticdl_tpu_torch.models.record_codec import write_synthetic_image_records
    from elasticdl_tpu_torch.worker.main import read_summaries

    name, batch, records = "cifar-process", 128, 1024
    data, log_dir = os.path.join(tmp, f"{name}-data"), os.path.join(tmp, f"{name}-logs")
    with logs_on_failure(log_dir):
        os.makedirs(data)
        for i in range(2):
            write_synthetic_image_records(os.path.join(data, f"shard-{i}.rio"), records,
                                          (32, 32, 3), 10, seed=i)
        output = os.path.join(tmp, f"{name}.ckpt")
        steps = 2 * records // batch
        os.environ[ENV_WORKER_LOG_DIR] = log_dir
        try:
            t0 = time.perf_counter()
            rc, master = master_main.run([
                "--model_def", "cifar10_functional_api.custom_model",
                "--minibatch_size", str(batch), "--training_data_dir", data,
                "--records_per_task", "512", "--num_epochs", "1", "--grads_to_wait", "1",
                "--num_workers", "2", "--worker_backend", "process", "--device", "cuda",
                "--output", output,
            ])
            wall = time.perf_counter() - t0
        finally:
            del os.environ[ENV_WORKER_LOG_DIR]
        if rc != 0:
            raise AssertionError(f"master.main exited {rc}")
        model = load_model_file(output)
        ex = {k: master[k] for k in ("version", "init_version", "applied_update_steps")}
        if model.version != steps or ex != {"version": steps, "init_version": 0,
                                            "applied_update_steps": steps}:
            raise AssertionError(f"--output version {model.version}, exactness {ex}, "
                                 f"{steps} steps expected")
        spec = image_spec("cifar10_functional_api.custom_model")
        flat = codec.ravel_np(model.params)
        if not np.isfinite(flat).all():
            raise AssertionError(f"{name}: the parameters are not finite")
        for seed in (0, 1):
            if np.array_equal(flat, codec.ravel_np(spec.model.init_params(seed))):
                raise AssertionError(f"{name}: the parameters did not move from init {seed}")
        check_aux(model.aux, spec.model, name)
        summaries = read_summaries(log_dir)
        card = torch.cuda.get_device_name(0)
        if sorted(summaries) != [0, 1]:
            raise AssertionError(f"worker summaries of {sorted(summaries)}, of [0, 1] expected")
        if sum(s["steps_accepted"] for s in summaries.values()) != steps:
            raise AssertionError(f"the workers' accepted steps do not sum to {steps}")
        for wid, s in summaries.items():
            if s["device"] != card or any(s["launches"].values()) or s["attention_fallbacks"]:
                raise AssertionError(f"worker {wid} on {s['device']!r}, launches "
                                     f"{s['launches']}, fallbacks {s['attention_fallbacks']}")
            if s["aux_absorbed"].get("GetModel", 0) <= 0:
                raise AssertionError(f"worker {wid} took no batch stats from a GetModel "
                                     f"response: {s['aux_absorbed']}")
        times = sorted(t for s in summaries.values() for t in s["accepted_at"])
        print(f"{name} job (master.main --model_def cifar10_functional_api.custom_model, 2 "
              f"workers, per-step, minibatch {batch}): rc {rc}, {wall:.2f} s, "
              f"{steps * batch / wall:.1f} images/s over the whole run (worker boot included), "
              f"{images_per_s(times, batch):.1f} images/s between the first and last accepted "
              f"steps; exactness {ex}; batch stats absorbed per worker "
              f"{[s['aux_absorbed'] for s in summaries.values()]}")
        for wid, s in summaries.items():
            print(f"{name} worker {wid}: {s['steps_accepted']} accepted, {s['steps_computed']} "
                  f"computed, phase seconds {rounded(s['phase_seconds'])}, client seconds "
                  f"{rounded(s['rpc_seconds'])}")
        server = master["server"]
        print(f"{name} master: server handler seconds {rounded(server['handler_seconds'])}, "
              f"calls {server['calls']}")


# BASELINE.json's "cifar10_subclass -- 4 async workers + 1 PS": 16,384
# synthetic training records (the reference's writer) in tasks of 1,024,
# 128 updates at minibatch 128, 2,048 evaluation records, an evaluation
# job every 32 versions, a checkpoint every 32 versions kept to 2
ASYNC_TRAIN, ASYNC_EVAL, ASYNC_TASK, ASYNC_BATCH = 16384, 2048, 1024, 128
ASYNC_WORKERS, ASYNC_EVAL_STEPS = 4, 32
ASYNC_STEPS = ASYNC_TRAIN // ASYNC_BATCH
CIFAR_SHAPE = (32, 32, 3)


def async_argv(data, evald, num_workers, **flags):
    """master.main's command line for cifar10_subclass at minibatch 128 on
    the card: `flags` name further flags (True: a bare switch)."""
    argv = ["--model_def", "cifar10_subclass.custom_model",
            "--minibatch_size", str(ASYNC_BATCH), "--records_per_task", str(ASYNC_TASK),
            "--num_workers", str(num_workers), "--worker_backend", "process",
            "--device", "cuda"]
    if data:
        argv += ["--training_data_dir", data]
    if evald:
        argv += ["--evaluation_data_dir", evald]
    for flag, value in flags.items():
        argv += [f"--{flag}"] if value is True else [f"--{flag}", str(value)]
    return argv


@contextlib.contextmanager
def environ(env):
    """`env` set in os.environ for the block (worker processes inherit
    it), the previous values back after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def run_master(argv, log_dir, env=(), on_start=None):
    """master.main's `run(argv, on_start)` in this process with the worker
    logs in `log_dir` and `env` set for the run: (rc, summary, wall
    seconds)."""
    from elasticdl_tpu_torch.common.constants import ENV_WORKER_LOG_DIR
    from elasticdl_tpu_torch.master import main as master_main

    with environ(dict(env, **{ENV_WORKER_LOG_DIR: log_dir})):
        t0 = time.perf_counter()
        rc, summary = master_main.run(argv, on_start=on_start)
        return rc, summary, time.perf_counter() - t0


def phase_async_process_job(tmp) -> dict:
    """`python -m elasticdl_tpu_torch.master.main --model_def
    cifar10_subclass.custom_model --worker_backend process --num_workers 4
    --use_async --lr_staleness_modulation --minibatch_size 128` with
    evaluation (`--evaluation_data_dir`, `--eval_steps 32`), checkpoints
    (`--checkpoint_steps 32 --keep_checkpoint_max 2`), the metrics sink
    (`--tensorboard_log_dir`, JSONL) and `--output`. Checks: rc 0; the
    `--output` version 128 = the workers' accepted steps (async accepts
    every report) and the exactness block; each worker on the card with 0
    attention launches and fallbacks; parameters finite and moved, batch
    statistics moved; every evaluation job over all 2,048 records (16
    minibatches of each job among the workers) at a version past its
    cadence point, accuracy in [0, 1]; the eval/accuracy rows of
    events.jsonl are those jobs', and train/loss has one row a version;
    the checkpoint directory holds exactly model_v96 and model_v128, each
    loading at its version with the SGD momentum traces as `opt_state`;
    no eval snapshot left behind. Returns what the standalone phase
    needs."""
    import glob
    import tempfile

    from elasticdl_tpu_torch.common import codec
    from elasticdl_tpu_torch.common.constants import ENV_TB_BACKEND
    from elasticdl_tpu_torch.master.checkpoint import load_model_file
    from elasticdl_tpu_torch.models.record_codec import write_synthetic_image_records
    from elasticdl_tpu_torch.worker.main import read_summaries

    name = "async-cifar"
    root = os.path.join(tmp, name)
    data, evald, log_dir, ckpt_dir, tb, snaps = (
        os.path.join(root, d) for d in ("train", "eval", "logs", "ckpt", "tb", "snapshots"))
    with logs_on_failure(log_dir):
        for d in (data, evald, snaps):
            os.makedirs(d)
        for i in range(4):
            write_synthetic_image_records(os.path.join(data, f"shard-{i}.rio"), ASYNC_TRAIN // 4,
                                          CIFAR_SHAPE, 10, seed=i)
        write_synthetic_image_records(os.path.join(evald, "eval.rio"), ASYNC_EVAL, CIFAR_SHAPE,
                                      10, seed=100)
        output = os.path.join(root, "final.ckpt")
        # the evaluation snapshots' temporary directory lands in `snaps`
        saved_tmp, tempfile.tempdir = tempfile.tempdir, snaps
        try:
            rc, master, wall = run_master(async_argv(
                data, evald, ASYNC_WORKERS, use_async=True, lr_staleness_modulation=True,
                eval_steps=ASYNC_EVAL_STEPS, checkpoint_dir=ckpt_dir, checkpoint_steps=32,
                keep_checkpoint_max=2, tensorboard_log_dir=tb, output=output,
            ), log_dir, {ENV_TB_BACKEND: "jsonl"})
        finally:
            tempfile.tempdir = saved_tmp
        if rc != 0:
            raise AssertionError(f"master.main exited {rc}")
        model = load_model_file(output)
        ex = {k: master[k] for k in ("version", "init_version", "applied_update_steps")}
        if model.version != ASYNC_STEPS or ex != {"version": ASYNC_STEPS, "init_version": 0,
                                                  "applied_update_steps": ASYNC_STEPS}:
            raise AssertionError(f"--output version {model.version}, exactness {ex}, "
                                 f"{ASYNC_STEPS} steps expected")
        summaries = read_summaries(log_dir)
        card = torch.cuda.get_device_name(0)
        if sorted(summaries) != list(range(ASYNC_WORKERS)):
            raise AssertionError(f"worker summaries of {sorted(summaries)}")
        accepted = sum(s["steps_accepted"] for s in summaries.values())
        if accepted != ASYNC_STEPS:
            raise AssertionError(f"the workers' accepted steps sum to {accepted}")
        for wid, s in summaries.items():
            if s["device"] != card or any(s["launches"].values()) or s["attention_fallbacks"]:
                raise AssertionError(f"worker {wid} on {s['device']!r}, launches "
                                     f"{s['launches']}, fallbacks {s['attention_fallbacks']}")
        failures = pipeline_lines(name, summaries, DEFAULT_ASYNC_DEPTH)
        if failures:
            raise AssertionError("\n".join(failures))
        spec = image_spec("cifar10_subclass.custom_model")
        flat = codec.ravel_np(model.params)
        if not np.isfinite(flat).all():
            raise AssertionError(f"{name}: the parameters are not finite")
        for seed in range(ASYNC_WORKERS):
            if np.array_equal(flat, codec.ravel_np(spec.model.init_params(seed))):
                raise AssertionError(f"{name}: the parameters did not move from init {seed}")
        check_aux(model.aux, spec.model, name)

        evaluations = master["evaluations"]
        versions = [v for v, _m in evaluations]
        per_job = ASYNC_EVAL // ASYNC_BATCH
        eval_minibatches = sum(s["eval_minibatches"] for s in summaries.values())
        if (not evaluations or versions != sorted(set(versions)) or versions[0] < ASYNC_EVAL_STEPS
                or versions[-1] > ASYNC_STEPS):
            raise AssertionError(f"evaluation jobs at versions {versions}")
        if eval_minibatches != per_job * len(evaluations) or sum(
                s["eval_tasks"] for s in summaries.values()) != 2 * len(evaluations):
            raise AssertionError(f"{eval_minibatches} eval minibatches for {len(evaluations)} "
                                 f"jobs of {per_job}")
        for v, m in evaluations:
            if not 0.0 <= m["accuracy"] <= 1.0:
                raise AssertionError(f"evaluation at v{v}: accuracy {m['accuracy']}")
        with open(os.path.join(tb, "events.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        acc_rows = [(r["step"], r["value"]) for r in rows if r["tag"] == "eval/accuracy"]
        loss_steps = sorted(r["step"] for r in rows if r["tag"] == "train/loss")
        if acc_rows != [(v, m["accuracy"]) for v, m in evaluations]:
            raise AssertionError(f"events.jsonl eval rows {acc_rows} != the jobs' {evaluations}")
        if loss_steps != list(range(1, ASYNC_STEPS + 1)):
            raise AssertionError(f"events.jsonl train/loss at steps {loss_steps}")
        files = sorted(os.listdir(ckpt_dir))
        if files != ["model_v128.ckpt", "model_v96.ckpt"]:
            raise AssertionError(f"checkpoint directory holds {files}")
        n_leaves = len(codec.tree_leaves(model.params))
        for v in (96, 128):
            ck = load_model_file(os.path.join(ckpt_dir, f"model_v{v}.ckpt"))
            leaves = (ck.opt_state or {}).get("leaves") or []
            if ck.version != v or ck.opt_state.get("kind") != "single" or len(leaves) != n_leaves:
                raise AssertionError(f"model_v{v}.ckpt: version {ck.version}, opt_state "
                                     f"{ck.opt_state and ck.opt_state.get('kind')} with "
                                     f"{len(leaves)} leaves, {n_leaves} traces expected")
        snap_dirs = glob.glob(os.path.join(snaps, "edl_torch_evalckpt_*"))
        left = glob.glob(os.path.join(snaps, "edl_torch_evalckpt_*", "*"))
        if not snap_dirs or left:
            raise AssertionError(f"eval snapshots: directories {snap_dirs}, left behind {left}")

        times = sorted(t for s in summaries.values() for t in s["accepted_at"])
        eval_worker_s = sum(s["phase_seconds"].get("eval", 0.0) for s in summaries.values())
        server = master["server"]
        print(f"{name} job (master.main --model_def cifar10_subclass.custom_model, "
              f"{ASYNC_WORKERS} async workers, --lr_staleness_modulation, minibatch "
              f"{ASYNC_BATCH}): rc {rc}, {wall:.2f} s, {ASYNC_STEPS * ASYNC_BATCH / wall:.1f} "
              f"images/s over the whole run (worker boot included), "
              f"{images_per_s(times, ASYNC_BATCH):.1f} images/s between the first and last "
              f"accepted steps; exactness {ex}; ReportGradient handler "
              f"{server['handler_seconds']['ReportGradient'] / ASYNC_STEPS:.4f} s a step "
              f"(calls {server['calls']})")
        print(f"{name} evaluations (version, accuracy): "
              f"{[(v, round(m['accuracy'], 4)) for v, m in evaluations]}; seconds per job from "
              f"its creation to its last task {[round(x, 2) for x in master['evaluation_seconds']]}"
              f", workers' eval-task seconds {eval_worker_s / len(evaluations):.3f} a job; "
              f"checkpoints {files}")
        for wid, s in summaries.items():
            print(f"{name} worker {wid}: {s['steps_accepted']} accepted, {s['steps_computed']} "
                  f"computed, {s['eval_tasks']} eval tasks, phase seconds "
                  f"{rounded(s['phase_seconds'])}")
        v128 = dict(evaluations).get(ASYNC_STEPS)
        return {"ckpt": os.path.join(ckpt_dir, f"model_v{ASYNC_STEPS}.ckpt"),
                "eval_dir": evald, "v128": v128}


def phase_standalone_eval_predict(fa, tmp, async_job):
    """Evaluation: `master.main --evaluation_data_dir <the async job's
    2,048 records> --checkpoint_filename_for_init <its model_v128.ckpt>`
    with 2 workers on the card: rc 0, one evaluation job at version 128,
    its accuracy within 2/2,048 (an argmax near-tie can move a count) of
    the same checkpoint's plain forward on the CPU over the same records,
    and of the async job's own evaluation at v128 when it made one.
    Prediction: mnist_functional_api from a checkpoint this phase writes,
    in-process on the card through the worker's PREDICTION path: the
    PredictionOutputsProcessor gets one class per record, equal to the CPU
    forward's wherever the CPU's top two logits are further apart than
    IMAGE_TOL's float32 logit limit times the largest |logit|."""
    from elasticdl_tpu_torch.convert import load_variables
    from elasticdl_tpu_torch.data.recordio import RecordIOReader
    from elasticdl_tpu_torch.master.checkpoint import load_model_file, save_model_file
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.models.record_codec import write_synthetic_image_records
    from elasticdl_tpu_torch.testing import InProcessMaster, build_job
    from elasticdl_tpu_torch.worker.main import read_summaries
    from elasticdl_tpu_torch.worker.worker import Worker

    log_dir = os.path.join(tmp, "standalone-eval-logs")
    with logs_on_failure(log_dir):
        rc, master, wall = run_master(async_argv(
            "", async_job["eval_dir"], 2,
            checkpoint_filename_for_init=async_job["ckpt"]), log_dir)
        if rc != 0 or master["job_type"] != "evaluation":
            raise AssertionError(f"the evaluation job exited {rc} ({master and master['job_type']})")
        if [v for v, _m in master["evaluations"]] != [ASYNC_STEPS]:
            raise AssertionError(f"standalone evaluations {master['evaluations']}")
        acc = master["evaluations"][0][1]["accuracy"]
        summaries = read_summaries(log_dir)
    ck = load_model_file(async_job["ckpt"])
    cpu_model = image_spec("cifar10_subclass.custom_model").model
    load_variables(cpu_model, ck.params, ck.aux)
    with RecordIOReader(os.path.join(async_job["eval_dir"], "eval.rio")) as r:
        x, y = image_spec("cifar10_subclass.custom_model").dataset_fn(
            list(r.read_range(0, ASYNC_EVAL)), "evaluation")
    with torch.no_grad():
        hits = sum(int((cpu_model(torch.from_numpy(x[i:i + 256]), train=False).argmax(-1)
                        == torch.from_numpy(np.asarray(y[i:i + 256], np.int64))).sum())
                   for i in range(0, ASYNC_EVAL, 256))
    cpu_acc = hits / ASYNC_EVAL
    limit = 2 / ASYNC_EVAL + 1e-12
    own = async_job["v128"]
    print(f"standalone evaluation (master.main --evaluation_data_dir, 2 workers, "
          f"model_v{ASYNC_STEPS}.ckpt): rc {rc}, {wall:.2f} s, accuracy {acc:.6f}; the same "
          f"checkpoint on the CPU {cpu_acc:.6f}; the async job's own evaluation at "
          f"v{ASYNC_STEPS}: {own['accuracy'] if own else 'none (its v128 trigger came while an earlier job was pending)'}"
          f"; eval tasks per worker {[s['eval_tasks'] for s in summaries.values()]}")
    if abs(acc - cpu_acc) > limit or (own and abs(acc - own["accuracy"]) > limit):
        raise AssertionError(f"standalone accuracy {acc} vs CPU {cpu_acc} / async {own}: more "
                             f"than 2/{ASYNC_EVAL} apart")

    spec = image_spec("mnist_functional_api.custom_model")
    n = 1024
    path = os.path.join(tmp, "predict.rio")
    write_synthetic_image_records(path, n, spec.module.IMAGE_SHAPE, spec.module.NUM_CLASSES,
                                  seed=7)
    params = spec.model.init_params(0)
    ckpt = os.path.join(tmp, "predict.ckpt")
    save_model_file(ckpt, params, 5)
    dispatcher = TaskDispatcher({}, {}, {path: n}, 256, 1)
    servicer, _e, _c = build_job(spec, dispatcher, checkpoint_filename_for_init=ckpt)
    worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=64, device="cuda")
    reset_counts(fa)
    t0 = time.perf_counter()
    ok = worker.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fallbacks = read_counts(fa)
    worker.close()
    outputs = spec.prediction_outputs_processor.outputs
    classes = np.concatenate([c for _w, c in outputs]) if outputs else np.zeros(0)
    if not ok or not dispatcher.finished() or classes.shape != (n,) or worker.prediction_tasks != 4:
        raise AssertionError(f"prediction: ok {ok}, {classes.shape} classes for {n} records, "
                             f"{worker.prediction_tasks} tasks")
    if any(launches.values()) or fallbacks:
        raise AssertionError(f"prediction: attention launches {launches}, fallbacks {fallbacks}")
    cpu = image_spec("mnist_functional_api.custom_model").model
    load_variables(cpu, params)
    with RecordIOReader(path) as r:
        x, _y = spec.dataset_fn(list(r.read_range(0, n)), "prediction")
    with torch.no_grad():
        logits = cpu(torch.from_numpy(x)).numpy()
    top2 = np.sort(logits, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > IMAGE_TOL["float32"]["logits"] * np.abs(logits).max()
    differ = int(np.sum(classes[clear] != logits.argmax(-1)[clear]))
    print(f"prediction (mnist_functional_api from a v5 checkpoint, in-process on the card, "
          f"minibatch 64): {n} classes in {wall:.2f} s; {differ} differ from the CPU forward "
          f"among the {int(clear.sum())} records whose top two logits are apart by more than "
          f"the limit ({n - int(clear.sum())} near-ties left out)")
    if differ:
        raise AssertionError(f"prediction: {differ} classes differ from the CPU forward")


# evaluation during training on the kernels' path: 8 per-step updates in
# 2 epochs of 4 tasks of one minibatch, an evaluation job every 4
# versions over 2 tasks of 8 records (one minibatch each)
EVAL_EVERY, EVAL_RECORDS = 4, 16


def eval_memory(model, x) -> float:
    """Peak device memory (GiB above what was allocated before) of one
    inference-mode forward of `model` on `x`."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.inference_mode():
        out = model(x)
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def eval_run(fa, tmp, name, model_params, tol) -> dict:
    """One in-process job of the zoo's transformer (`model_params`) on the
    card with evaluation during training. Each evaluation minibatch adds
    exactly n_layers flash_forward launches at the model's head dim and
    no dq or dk+dv launch (`torch.inference_mode()`, no autograd graph),
    and no fallback; the evaluation jobs complete at versions 4 and 8,
    each minibatch's perplexity = exp(its cross entropy); the training
    report after the v4 job is accepted at the version the worker left;
    the v8 job's cross entropy equals the plain model's (the PS's v8
    snapshot with `reference_attention` materialized on the card) over
    the same records within `tol`. Returns the evaluation's launches."""
    from elasticdl_tpu_torch.api.model_spec import get_model_spec
    from elasticdl_tpu_torch.convert import load_variables
    from elasticdl_tpu_torch.data.recordio import RecordIOReader
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.models import transformer_lm as tlm
    from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
    from elasticdl_tpu_torch.testing import InProcessMaster, build_job
    from elasticdl_tpu_torch.worker.worker import Worker

    spec = get_model_spec(ZOO, "transformer_lm_zoo.custom_model", model_params)
    cfg = spec.model.cfg
    train, evals = os.path.join(tmp, f"{name}-train.rio"), os.path.join(tmp, f"{name}-eval.rio")
    write_learnable_token_records(train, BATCH * EVAL_EVERY, SEQ, cfg.vocab, seed=0)
    write_learnable_token_records(evals, EVAL_RECORDS, SEQ, cfg.vocab, seed=5)
    dispatcher = TaskDispatcher({train: BATCH * EVAL_EVERY}, {evals: EVAL_RECORDS}, {}, BATCH,
                                2, shuffle_seed=0)
    servicer, evs, _ckpt = build_job(spec, dispatcher, eval_steps=EVAL_EVERY)
    steps = 2 * EVAL_EVERY
    # (what, its fields, the launch counts just after it): each training
    # report's version sent, version back and acceptance, each evaluation
    # minibatch's metrics, and the start of each evaluation task
    log = []

    class RecordingMaster(InProcessMaster):
        def call(self, method, request=None):
            resp = super().call(method, request)
            if method == "ReportGradient":
                log.append((method, {"sent": request["version"], "back": resp["version"],
                                     "accepted": resp["accepted"]}, fa.launch_counts()))
            elif method == "ReportEvaluationMetrics":
                log.append((method, request["metrics"], fa.launch_counts()))
            return resp

    worker = Worker(0, RecordingMaster(servicer), spec, minibatch_size=BATCH, device="cuda",
                    seed=0)
    evaluate = worker._process_evaluation_task

    def marked(task):
        log.append(("eval task", None, fa.launch_counts()))
        evaluate(task)

    worker._process_evaluation_task = marked
    reset_counts(fa)
    t0 = time.perf_counter()
    ok = worker.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fallbacks = read_counts(fa)
    worker.close()
    n_eval = worker.eval_minibatches
    d, L = cfg.head_dim, cfg.n_layers
    per_minibatch = want_launches(d, {"flash_forward": L, "flash_dq": 0, "flash_dkv": 0})
    eval_launches = want_launches(d, {"flash_forward": L * n_eval, "flash_dq": 0, "flash_dkv": 0})
    want = want_launches(d, {"flash_forward": L * (steps + n_eval), "flash_dq": L * steps,
                             "flash_dkv": L * steps})
    failures = []
    if not ok or not dispatcher.finished() or servicer.exactness() != {
            "version": steps, "init_version": 0, "applied_update_steps": steps}:
        failures.append(f"the job did not finish cleanly: {servicer.exactness()}")
    if [v for v, _m in evs.completed_metrics] != [EVAL_EVERY, 2 * EVAL_EVERY] or n_eval != 4:
        failures.append(f"evaluation jobs {evs.completed_metrics}, {n_eval} minibatches")
    if launches != want or fallbacks:
        failures.append(f"launches {launches}, {want} expected; fallbacks {fallbacks}")
    prev, last_version, left_at, next_report = None, None, None, []
    for what, fields, counts in log:
        if what == "eval task":
            left_at = last_version
        elif what == "ReportEvaluationMetrics":
            got = {k: counts[k] - prev[k] for k in counts}
            m = fields
            if got != per_minibatch:
                failures.append(f"an eval minibatch launched {got}, {per_minibatch} expected")
            if not (math.isfinite(m["cross_entropy"]) and math.isclose(
                    m["perplexity"], math.exp(m["cross_entropy"]), rel_tol=1e-6)):
                failures.append(f"eval minibatch metrics {m}")
        else:
            if left_at is not None:
                next_report.append((left_at, fields["sent"], fields["accepted"]))
                left_at = None
            last_version = fields["back"]
        prev = counts
    if not next_report or any(left != v or not acc for left, v, acc in next_report):
        failures.append(f"training reports after an eval (left at, sent at, accepted): "
                        f"{next_report}")
    params, _aux, _v = servicer.get_params_copy()
    plain = get_model_spec(ZOO, "transformer_lm_zoo.custom_model", model_params).model.cuda()
    load_variables(plain, params)
    with RecordIOReader(evals) as r:
        records = list(r.read_range(0, EVAL_RECORDS))
    ce_sum, kernel_attention = 0.0, tlm.attention
    tlm.attention = fa.reference_attention
    try:
        with torch.inference_mode():
            for i in range(0, EVAL_RECORDS, BATCH):
                x, y = spec.dataset_fn(records[i:i + BATCH], "evaluation")
                logits = plain(torch.from_numpy(np.asarray(x, np.int64)).cuda())
                ce_sum += float(tlm.token_cross_entropy(
                    logits, torch.from_numpy(np.asarray(y, np.int64)).cuda())) * len(x)
    finally:
        tlm.attention = kernel_attention
    plain_ce = ce_sum / EVAL_RECORDS
    job_ce = evs.completed_metrics[-1][1]["cross_entropy"] if evs.completed_metrics else math.nan
    if not abs(job_ce - plain_ce) <= tol["atol"] + tol["rtol"] * abs(plain_ce):
        failures.append(f"v8 eval cross entropy {job_ce} vs the plain model's {plain_ce}")
    x = torch.from_numpy(np.asarray(spec.dataset_fn(records[:BATCH], "evaluation")[0],
                                    np.int64)).cuda()
    eval_gib = eval_memory(plain, x)
    train_gib = peak_step_memory(cfg, BATCH, (("off", False, ""),))["off"]
    print(f"eval during training ({name}, --model_params {model_params!r}: {cfg.dtype}, head "
          f"dim {d}, {L} layers): {steps} steps and {n_eval} eval minibatches in {wall:.2f} s; "
          f"jobs {[(v, {k: round(x, 4) for k, x in m.items()}) for v, m in evs.completed_metrics]}"
          f"; v8 cross entropy {job_ce:.6f} against the plain model's {plain_ce:.6f} (|diff| "
          f"{abs(job_ce - plain_ce):.2e}); eval launches {eval_launches}; after-eval reports "
          f"(left at, sent at, accepted) {next_report}; peak memory beyond the model: an eval "
          f"minibatch {eval_gib:.3f} GiB, a training step {train_gib:.3f} GiB (params, grads "
          f"and batch excluded); worker phases {rounded(worker.phase_seconds)}")
    if failures:
        raise AssertionError(f"eval during training ({name}):\n" + "\n".join(failures))
    return eval_launches


def phase_eval_kernels(fa, tmp) -> dict:
    """Evaluation during training through the kernels' forward alone:
    the base transformer at full width in bf16 (head dim 64, held to the
    bf16 output limit) and the zoo's default in float32 (head dim 16, the
    CUDA-core forward, held to MODEL_TOL). Returns each dtype's
    evaluation launches."""
    return {
        "bfloat16": eval_run(fa, tmp, "base", SLICE_PARAMS, BF16_TOL["o"]),
        "float32": eval_run(fa, tmp, "zoo", "", MODEL_TOL),
    }


RESUME_EPOCH = BATCH * 4  # one task an epoch, 4 updates


def resume_run(path, epochs, ckpt_init=""):
    """The zoo's default (float32) on the card, one worker, grads_to_wait
    1, one task an epoch, booted from `ckpt_init` when given: (servicer,
    final flat params, version)."""
    from elasticdl_tpu_torch.api.model_spec import get_model_spec
    from elasticdl_tpu_torch.common import codec
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.testing import InProcessMaster, build_job
    from elasticdl_tpu_torch.worker.worker import Worker

    spec = get_model_spec(ZOO, "transformer_lm_zoo.custom_model", "")
    dispatcher = TaskDispatcher({path: RESUME_EPOCH}, {}, {}, RESUME_EPOCH, epochs)
    servicer, _e, _c = build_job(spec, dispatcher, checkpoint_filename_for_init=ckpt_init)
    worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=BATCH, device="cuda",
                    seed=0)
    if not worker.run() or not dispatcher.finished():
        raise AssertionError(f"resume run ({epochs} epochs, {ckpt_init!r}) did not finish")
    worker.close()
    params, _aux, version = servicer.get_params_copy()
    return servicer, codec.ravel_np(params), version


def gradient_spread(path) -> dict:
    """{leaf: max |difference|} of the zoo default's gradient between two
    identical forward + backward passes on the card (the leaves that
    differ: the card's run-to-run spread, by where it arises)."""
    from elasticdl_tpu_torch.common import codec
    from elasticdl_tpu_torch.data.recordio import RecordIOReader
    from elasticdl_tpu_torch.models import transformer_lm as tlm
    from elasticdl_tpu_torch.models import transformer_lm_zoo as zoo

    cfg = zoo.custom_model().cfg
    host = tlm.init_params(np.random.default_rng(0), cfg)
    params = codec.tree_map(lambda a: torch.from_numpy(a).cuda().requires_grad_(), host)
    with RecordIOReader(path) as r:
        x, y = zoo.dataset_fn(list(r.read_range(0, BATCH)), "training")
    x, y = (torch.from_numpy(np.asarray(a, np.int64)).cuda() for a in (x, y))
    leaves = codec.tree_leaves(params)
    grads = [torch.autograd.grad(tlm.token_cross_entropy(tlm.plain_forward(cfg, params, x)[0], y),
                                 leaves) for _ in range(2)]
    return {"/".join(p): float((a - b).abs().max()) for p, a, b in
            zip(codec.tree_paths(host), *grads) if not torch.equal(a, b)}


def phase_resume(tmp):
    """Exact resume on the card (the reference's protocol,
    `tests/test_exact_resume.py`): the zoo's default in float32 (its
    kernels have no atomics), 2 epochs uninterrupted (twice: the second
    run shows whether the card repeats itself bit for bit), 1 epoch then
    `save_latest_checkpoint` then 1 resumed epoch, and a control resumed
    from the same file with `opt_state` stripped. The resumed run lands at
    the uninterrupted version, bit-equal when the two uninterrupted runs
    are (else within 1e-6, the card's own run-to-run spread), and the
    control at least 100 times farther."""
    from elasticdl_tpu_torch.master.checkpoint import load_model_file, save_model_file
    from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records

    path = os.path.join(tmp, "resume.rio")
    write_learnable_token_records(path, RESUME_EPOCH, SEQ, ZOO_DEFAULT["vocab"], seed=0)
    _s, full, full_v = resume_run(path, 2)
    _s, again, _v = resume_run(path, 2)
    first, _vec, v1 = resume_run(path, 1)
    ckpt = os.path.join(tmp, "resume-mid.ckpt")
    first.save_latest_checkpoint(ckpt)
    resumed_s, resumed, resumed_v = resume_run(path, 1, ckpt)
    m = load_model_file(ckpt)
    stripped = os.path.join(tmp, "resume-stripped.ckpt")
    save_model_file(stripped, m.params, m.version, aux=m.aux)
    _s, control, _cv = resume_run(path, 1, stripped)
    spread = float(np.max(np.abs(again - full)))
    resumed_d = float(np.max(np.abs(resumed - full)))
    control_d = float(np.max(np.abs(control - full)))
    bit_equal = resumed.tobytes() == full.tobytes()
    spread_by_leaf = gradient_spread(path)
    print(f"resume on the card (zoo default, f32, {RESUME_EPOCH // BATCH} steps an epoch): "
          f"uninterrupted v{full_v}, resumed v{resumed_v} (exactness "
          f"{resumed_s.exactness()}); max|resumed - uninterrupted| {resumed_d:.3e} "
          f"(bit-equal: {bit_equal}), max|control - uninterrupted| {control_d:.3e}; two "
          f"uninterrupted runs differ by {spread:.3e}; the gradient leaves that differ between "
          f"two identical steps (max |diff|): {spread_by_leaf}")
    if resumed_v != full_v or resumed_s.exactness() != {
            "version": full_v, "init_version": v1, "applied_update_steps": full_v - v1}:
        raise AssertionError(f"resumed at v{resumed_v} ({resumed_s.exactness()}), not v{full_v}")
    if spread == 0.0 and not bit_equal:
        raise AssertionError(f"the card repeats itself bit for bit, but the resume is "
                             f"{resumed_d:.3e} away")
    if resumed_d > 1e-6 or not control_d >= 100 * resumed_d or control_d == 0.0:
        raise AssertionError(f"resumed {resumed_d:.3e}, control {control_d:.3e} from the "
                             f"uninterrupted run")


# -- ResNet-50 across worker processes: the transport tiers, the async PS
# with 8 workers, warm standbys under churn

# ResNet-50's gradient and model travel as one float32 vector each
RESNET_DEF = "resnet50_subclass.custom_model"
PROBE_ROUNDS = 10
PROBE_SERVER = r"""
import os, sys
import numpy as np
from elasticdl_tpu_torch.rpc.server import RpcServer
n = int(sys.argv[1])
model = np.arange(n, dtype=np.float32)
srv = RpcServer({"ReportGradient": lambda req: {"accepted": True, "version": 1,
                                                 "params_flat": model}}, port=0)
srv.start()
print(srv.port, flush=True)
sys.stdin.read()  # until the client closes the pipe
srv.stop()
"""


def resnet_param_count() -> int:
    from elasticdl_tpu_torch.models import resnet50_subclass

    return sum(p.numel() for p in resnet50_subclass.custom_model().parameters())


def shm_ring_for(n_params: int) -> int:
    """A ring that holds one frame of `n_params` float32 and its header."""
    return 4 * n_params + (1 << 20)


def port_segments(pid=None) -> list:
    """/dev/shm segments of the port's shm servers in process `pid`
    (this one by default)."""
    from elasticdl_tpu_torch.rpc import transport

    mark = f".{os.getpid() if pid is None else pid}."
    return sorted(n for n in os.listdir("/dev/shm")
                  if n.startswith(transport.SHM_SEGMENT_PREFIX) and mark in n)


@contextlib.contextmanager
def tier_dir():
    """One short EDL_UDS_DIR straight under the temp dir for the fast
    tiers' sockets and rendezvous files: an AF_UNIX path holds at most
    107 bytes, and a deep TMPDIR would push a socket past it (the server
    would then serve TCP only). Fails up front when even this one is too
    long, and at the end when a file was left in it."""
    import shutil

    from elasticdl_tpu_torch.rpc import transport

    uds = tempfile.mkdtemp(prefix="edlt")
    try:
        with environ({"EDL_UDS_DIR": uds}):
            longest = max(len(transport.uds_path_for(65535)),
                          len(transport.shm_doorbell_path(65535)))
        if longest >= 108:
            raise AssertionError(f"a socket under {uds!r} takes {longest} bytes, over "
                                 f"AF_UNIX's 107: set TMPDIR to a shorter directory")
        yield uds
        left = os.listdir(uds)
        if left:
            raise AssertionError(f"the fast tiers left {left} in {uds}")
    finally:
        shutil.rmtree(uds, ignore_errors=True)


def phase_transport_probe(uds):
    """One ResNet-50-sized ReportGradient (23.5M float32 gradients, about
    94 MB) and a model-sized response round trip between this process
    and a server process on the host, over tcp, uds, shm at the default
    4 MiB ring (the chunked path) and shm with a ring that holds the
    whole frame: 10 round trips each after one warm-up, median ms and
    GB/s (both frames' bytes over the median). Each client's link takes
    its tier from EDL_TRANSPORT as the client is built; the server's
    sockets and rendezvous files go in `uds`. No tier is required to
    win; each link must run on the tier asked for, every response must
    carry the model, and no segment or file may be left."""
    from elasticdl_tpu_torch.common import messages
    from elasticdl_tpu_torch.rpc.client import RpcClient

    n = resnet_param_count()
    grad = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    req = {"worker_id": 0, "version": 0, "gradient_flat": grad, "loss": 1.0, "return_model": True}
    req_bytes = len(messages.pack(req))
    resp_bytes = len(messages.pack({"accepted": True, "version": 1,
                                    "params_flat": np.zeros(n, np.float32)}))
    repo = os.path.dirname(os.path.abspath(__file__))
    configs = (("auto", None, (("grpc", "tcp"), ("uds", "uds"), ("shm", "shm 4 MiB ring"))),
               ("shm", shm_ring_for(n), (("shm", "shm whole-frame ring"),)))
    rows = []
    for mode, ring, tiers in configs:
        env = {"EDL_UDS_DIR": uds, "EDL_TRANSPORT": mode}
        if ring:
            env["EDL_TRANSPORT_SHM_RING_BYTES"] = str(ring)
        with environ(env):
            server = subprocess.Popen(
                [sys.executable, "-c", PROBE_SERVER, str(n)],
                env=dict(os.environ, PYTHONPATH=repo), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True)
            try:
                port = int(server.stdout.readline())
                for tier, label in tiers:
                    with environ({"EDL_TRANSPORT": tier}):
                        client = RpcClient(f"localhost:{port}")
                    want = "tcp" if tier == "grpc" else tier
                    if client.tier != want:
                        raise AssertionError(f"probe: {label} link on {client.tier}")
                    walls = []
                    for i in range(PROBE_ROUNDS + 1):
                        t0 = time.perf_counter()
                        resp = client.call("ReportGradient", req)
                        walls.append(time.perf_counter() - t0)
                        if i == 0 and not (resp["params_flat"][:1000] == np.arange(1000)).all():
                            raise AssertionError(f"probe: {label} response lost the model")
                    codec_s = client.codec_seconds["ReportGradient"] / (PROBE_ROUNDS + 1)
                    client.close()
                    med = statistics.median(walls[1:])
                    rows.append((label, med, codec_s))
                    print(f"transport probe {label}: median {med * 1e3:.2f} ms a round trip "
                          f"({req_bytes / 1e6:.1f} MB up, {resp_bytes / 1e6:.1f} MB down; "
                          f"{(req_bytes + resp_bytes) / med / 1e9:.2f} GB/s), min "
                          f"{min(walls[1:]) * 1e3:.2f}, codec {codec_s * 1e3:.2f} ms a call; "
                          f"{os.cpu_count()} CPUs")
            finally:
                server.stdin.close()
                server.wait(timeout=60)
            left = port_segments(server.pid)
            if left:
                raise AssertionError(f"probe server left {left}")
    left = [f for f in os.listdir(uds) if f.startswith("edlt")]
    if left:
        raise AssertionError(f"probe left {left}")
    return rows


# BASELINE.json's "imagenet_resnet50 -- 8 TPU workers, async PS": the zoo's
# ResNet-50 (64x64x3, 10 classes) on 8 worker processes on one card,
# 4,096 records (cut from 16,384, then 8,192, for the shard recovery and
# the observability phases' room) converted from tars of .npy images in
# 8 shards, tasks of 512, minibatch 128: 8 tasks, 1 a worker, 32 updates
IMAGENET_RECORDS, IMAGENET_SHARDS, IMAGENET_WORKERS = 4096, 8, 8
IMAGENET_BATCH, IMAGENET_TASK = 128, 512
IMAGENET_STEPS = IMAGENET_RECORDS // IMAGENET_BATCH
IMAGENET_SHAPE = (64, 64, 3)


def write_image_tars(raw, n_tars, per_tar, shape, seed=0) -> list:
    """Tars of `<label>/<n>.npy` uint8 images (labels 0-9) from `seed`."""
    import io
    import tarfile

    rng = np.random.default_rng(seed)
    paths = []
    for t in range(n_tars):
        images = rng.integers(0, 256, (per_tar,) + shape, dtype=np.uint8)
        labels = rng.integers(0, 10, per_tar)
        path = os.path.join(raw, f"part-{t:02d}.tar")
        with tarfile.open(path, "w") as tar:
            for i in range(per_tar):
                buf = io.BytesIO()
                np.save(buf, images[i])
                info = tarfile.TarInfo(f"{labels[i]}/{t * per_tar + i}.npy")
                info.size = buf.tell()
                buf.seek(0)
                tar.addfile(info, buf)
        paths.append(path)
    return paths


def rpc_split(s) -> dict:
    """A worker summary's client seconds by method: [codec, the rest]."""
    return {m: [round(s["rpc_codec_seconds"].get(m, 0.0), 3),
                round(v - s["rpc_codec_seconds"].get(m, 0.0), 3)]
            for m, v in s["rpc_seconds"].items()}


def phase_imagenet_async(tmp, uds, depth=None):
    """`BASELINE.json`'s third config: tars of 8,192 64x64x3 uint8 images
    (labels 0-9) converted by `data/recordio_gen/parallel_convert` with
    `models/imagenet_resnet50.py` as the prep module into 8 shards, then
    `master.main --model_def imagenet_resnet50.custom_model --use_async
    --lr_staleness_modulation --worker_backend process --num_workers 8
    --minibatch_size 128 --records_per_task 512` (one epoch, 64 updates)
    over EDL_TRANSPORT=shm with a ring that holds a whole frame. Checks: rc
    0; version = init + 64 = the workers' accepted steps; finite losses;
    parameters and batch statistics moved; every worker's link on shm; no
    failed task; no segment of the port's prefix left after the master
    exits; each worker at the reference's default per-step depth (4
    reports in flight), or at `--step_pipeline depth`. Prints steady
    images/s, the ReportGradient handler a step, each worker's pipeline
    and client seconds by method (codec, the rest), the tiers, one
    worker's peak device memory and the CPU count. The tier's sockets and
    rendezvous files go in `uds`."""
    from elasticdl_tpu_torch.common import codec
    from elasticdl_tpu_torch.data.recordio import count_records
    from elasticdl_tpu_torch.data.recordio_gen import parallel_convert
    from elasticdl_tpu_torch.master.checkpoint import load_model_file
    from elasticdl_tpu_torch.worker.main import read_summaries

    name = "imagenet-async" + ("" if depth is None else f" depth {depth}")
    # a directory of its own per run: the phase may run more than once
    root = tempfile.mkdtemp(prefix=name.replace(" ", "-"), dir=tmp)
    raw, data, log_dir = (os.path.join(root, d) for d in ("raw", "data", "logs"))
    os.makedirs(raw)
    with logs_on_failure(log_dir):
        t0 = time.perf_counter()
        tars = write_image_tars(raw, IMAGENET_SHARDS, IMAGENET_RECORDS // IMAGENET_SHARDS,
                                IMAGENET_SHAPE)
        t1 = time.perf_counter()
        prep = os.path.join(ZOO, "imagenet_resnet50.py")
        shards = parallel_convert.convert_files(tars, prep, data, records_per_shard=1,
                                                num_workers=IMAGENET_SHARDS)
        counts = [count_records(p) for p in shards]
        t2 = time.perf_counter()
        if counts != [IMAGENET_RECORDS // IMAGENET_SHARDS] * IMAGENET_SHARDS:
            raise AssertionError(f"{name}: shards of {counts} records")
        print(f"{name} data: {len(tars)} tars written in {t1 - t0:.2f} s, converted by "
              f"parallel_convert into {len(shards)} shards of {counts[0]} records in "
              f"{t2 - t1:.2f} s")
        n = resnet_param_count()
        output = os.path.join(root, "final.ckpt")
        argv = ["--model_def", "imagenet_resnet50.custom_model", "--use_async",
                "--lr_staleness_modulation", "--worker_backend", "process",
                "--num_workers", str(IMAGENET_WORKERS), "--minibatch_size", str(IMAGENET_BATCH),
                "--records_per_task", str(IMAGENET_TASK), "--training_data_dir", data,
                "--device", "cuda", "--envs", "OMP_NUM_THREADS=1", "--output", output]
        if depth is not None:
            argv += ["--step_pipeline", str(depth)]
        env = {"EDL_TRANSPORT": "shm", "EDL_TRANSPORT_SHM_RING_BYTES": str(shm_ring_for(n)),
               "EDL_UDS_DIR": uds}
        rc, master, wall = run_master(argv, log_dir, env)
        left = port_segments()
        if rc != 0 or left:
            raise AssertionError(f"{name}: master.main exited {rc}; segments left {left}")
        model = load_model_file(output)
        ex = {k: master[k] for k in ("version", "init_version", "applied_update_steps")}
        if model.version != IMAGENET_STEPS or ex != {
                "version": IMAGENET_STEPS, "init_version": 0,
                "applied_update_steps": IMAGENET_STEPS}:
            raise AssertionError(f"{name}: --output v{model.version}, exactness {ex}")
        summaries = read_summaries(log_dir)
        if sorted(summaries) != list(range(IMAGENET_WORKERS)):
            raise AssertionError(f"{name}: worker summaries of {sorted(summaries)}")
        accepted = sum(s["steps_accepted"] for s in summaries.values())
        losses = [x for s in summaries.values() for x in s["losses"]]
        tiers = {wid: s["tier"] for wid, s in summaries.items()}
        card = torch.cuda.get_device_name(0)
        if accepted != IMAGENET_STEPS or set(tiers.values()) != {"shm"}:
            raise AssertionError(f"{name}: {accepted} accepted steps, tiers {tiers}")
        if not losses or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: losses {losses}")
        for wid, s in summaries.items():
            if s["device"] != card or any(s["launches"].values()) or s["attention_fallbacks"]:
                raise AssertionError(f"{name} worker {wid} on {s['device']!r}, launches "
                                     f"{s['launches']}, fallbacks {s['attention_fallbacks']}")
        failures = pipeline_lines(name, summaries,
                                  DEFAULT_ASYNC_DEPTH if depth is None else depth)
        if failures:
            raise AssertionError("\n".join(failures))
        spec = image_spec("imagenet_resnet50.custom_model")
        flat = codec.ravel_np(model.params)
        if not np.isfinite(flat).all():
            raise AssertionError(f"{name}: the parameters are not finite")
        for seed in range(IMAGENET_WORKERS):
            if np.array_equal(flat, codec.ravel_np(spec.model.init_params(seed))):
                raise AssertionError(f"{name}: the parameters did not move from init {seed}")
        check_aux(model.aux, spec.model, name)
        times = sorted(t for s in summaries.values() for t in s["accepted_at"])
        server = master["server"]
        peak = max(s["peak_memory_bytes"] for s in summaries.values())
        print(f"{name} job (master.main --model_def imagenet_resnet50.custom_model, "
              f"{IMAGENET_WORKERS} async worker processes over shm, minibatch "
              f"{IMAGENET_BATCH}, {n} parameters): rc {rc}, {wall:.2f} s, "
              f"{images_per_s(times, IMAGENET_BATCH):.1f} steady images/s (first to last "
              f"accepted step), {IMAGENET_STEPS * IMAGENET_BATCH / wall:.1f} over the run; "
              f"exactness {ex}; ReportGradient handler "
              f"{server['handler_seconds']['ReportGradient'] / IMAGENET_STEPS:.4f} s a step, "
              f"server codec {server['codec_seconds']['ReportGradient'] / IMAGENET_STEPS:.4f} "
              f"s a step; tiers {tiers}; peak device memory of one worker "
              f"{peak / 2**30:.3f} GiB; {os.cpu_count()} CPUs")
        for wid, s in summaries.items():
            print(f"{name} worker {wid}: {s['steps_accepted']} accepted, {s['steps_computed']} "
                  f"computed, phase seconds {rounded(s['phase_seconds'])}, client seconds by "
                  f"method [codec, rest] {rpc_split(s)}")


# BASELINE.json's "resnet50_subclass elastic -- preemptible pool, 50% worker
# churn" on bench_elastic.py's protocol: 4 active workers and 1 standby,
# window mode (W 2, minibatch 64, tasks of 128: one window a task), 8,192
# synthetic records in 4 shards, 2 epochs, over shm
CHURN_RECORDS, CHURN_EPOCHS, CHURN_WORKERS, CHURN_STANDBY = 8192, 2, 4, 1
CHURN_BATCH, CHURN_TASK, CHURN_WINDOW = 64, 128, 2
CHURN_STEPS = CHURN_RECORDS * CHURN_EPOCHS // CHURN_BATCH
CHURN_WAVES = (0.25, 0.5, 0.75)  # of the records, half the live active pool each
CHURN_LIMIT_S = 420.0
WORKER_LOG_EVENTS = {
    "standby": "held as a standby",
    "warm": "standby pre-warm complete",
    "warm_failed": "standby pre-warm failed",
    "promoted": "promoted from standby at ",
    "first_step": "first step accepted at ",
}


def worker_log_events(log_dir) -> dict:
    """{worker id: {event: perf_counter time or True}} from the worker
    logs (a SIGKILLed worker logs no summary, but these lines)."""
    out = {}
    for name in sorted(os.listdir(log_dir)):
        wid = int(name.split("-")[1].split(".")[0])
        ev = out.setdefault(wid, {})
        with open(os.path.join(log_dir, name)) as f:
            for line in f:
                for key, text in WORKER_LOG_EVENTS.items():
                    if text in line:
                        tail = line.split(text, 1)[1].split()
                        ev[key] = float(tail[0]) if text.endswith("at ") else True
    return out


def churn_run(tmp, uds, data, name, churn):
    """One run of the protocol: the master's parts as master.main wires
    them, the clock from the first completed task; with `churn`, half of
    the live active workers SIGKILLed at each of CHURN_WAVES. Returns the
    run's numbers; raises on a broken condition."""
    from elasticdl_tpu_torch.cluster.pod_backend import PodPhase, ProcessBackend
    from elasticdl_tpu_torch.common.args import master_parser, parse_envs, worker_forward_args
    from elasticdl_tpu_torch.master.main import build_master, make_sample_batch_fn
    from elasticdl_tpu_torch.master.worker_manager import WorkerManager
    from elasticdl_tpu_torch.rpc.server import RpcServer
    from elasticdl_tpu_torch.worker.main import read_summaries

    log_dir = os.path.join(tmp, f"{name}-logs")
    args = master_parser().parse_args([
        "--model_def", RESNET_DEF, "--minibatch_size", str(CHURN_BATCH),
        "--training_data_dir", data, "--records_per_task", str(CHURN_TASK),
        "--num_epochs", str(CHURN_EPOCHS), "--local_updates", str(CHURN_WINDOW),
        "--num_workers", str(CHURN_WORKERS), "--num_standby_workers", str(CHURN_STANDBY),
        "--worker_backend", "process", "--device", "cuda", "--envs", "OMP_NUM_THREADS=1"])
    env = {"EDL_TRANSPORT": "shm",
           "EDL_TRANSPORT_SHM_RING_BYTES": str(shm_ring_for(resnet_param_count())),
           "EDL_UDS_DIR": uds}
    total = CHURN_RECORDS * CHURN_EPOCHS
    kill_points = [int(total * f) for f in CHURN_WAVES] if churn else []
    kills = []  # (perf_counter, victims, live active)
    with environ(env), logs_on_failure(log_dir):
        _spec, dispatcher, servicer, _eval, _ckpt = build_master(args)
        server = RpcServer(servicer.handlers(), port=0)
        server.start()
        addr = f"localhost:{server.port}"
        backend = ProcessBackend(log_dir=log_dir)
        manager = WorkerManager(backend, dispatcher, num_workers=CHURN_WORKERS,
                                worker_argv_fn=lambda wid: worker_forward_args(args, wid, addr),
                                envs=parse_envs(args.envs), max_relaunches=2 * CHURN_WORKERS,
                                num_standby=CHURN_STANDBY)
        servicer.set_standby_fn(manager.is_standby)
        servicer.set_sample_batch_fn(make_sample_batch_fn(data))
        try:
            manager.start_workers()
            t0 = c0 = None
            deadline = time.monotonic() + CHURN_LIMIT_S
            while not dispatcher.finished():
                if time.monotonic() > deadline:
                    raise AssertionError(f"{name}: not finished in {CHURN_LIMIT_S:.0f} s")
                if manager.all_exited():
                    raise AssertionError(f"{name}: every worker exited with tasks left")
                done = dispatcher.completed_records()
                if t0 is None and done > 0:
                    t0, c0 = time.perf_counter(), done
                if len(kills) < len(kill_points) and done >= kill_points[len(kills)]:
                    alive = [wid for wid, ph in manager.phases().items()
                             if ph in (PodPhase.PENDING, PodPhase.RUNNING)
                             and not manager.is_standby(wid) and backend.pid_of(wid)]
                    victims = sorted(alive)[: max(1, len(alive) // 2)]
                    at = time.perf_counter()
                    for wid in victims:
                        pid = backend.pid_of(wid)
                        if pid:
                            os.kill(pid, signal.SIGKILL)
                    kills.append((at, victims, len(alive), done))
                time.sleep(0.02)
            elapsed = time.perf_counter() - t0
            processed = dispatcher.completed_records() - c0
            deadline = time.monotonic() + 120
            while not manager.all_exited() and time.monotonic() < deadline:
                time.sleep(0.1)
            # every client is gone: each connection's segment, the killed
            # workers' too, was unlinked when its doorbell read EOF
            deadline = time.monotonic() + 10
            while port_segments() and time.monotonic() < deadline:
                time.sleep(0.05)
            leaked = port_segments()
        finally:
            manager.stop_relaunch_and_remove_workers()
            backend.stop()
            server.stop()
        ex = servicer.exactness()
        failed = dispatcher.has_failed_tasks()
        summaries = read_summaries(log_dir)
        events = worker_log_events(log_dir)
        out = {"rate": processed / elapsed, "elapsed": elapsed, "kills": kills,
               "relaunches": manager.relaunches(), "promotions": manager.promotions(),
               "exactness": ex, "summaries": summaries, "events": events}
        if leaked or failed or ex != {"version": CHURN_STEPS, "init_version": 0,
                                      "applied_update_steps": CHURN_STEPS}:
            raise AssertionError(f"{name}: leaked segments {leaked}, failed tasks {failed}, "
                                 f"exactness {ex} ({CHURN_STEPS} minibatches)")
        for wid, s in summaries.items():
            if s["tier"] != "shm" or s["steps_computed"] != (
                    s["steps_accepted"] + CHURN_WINDOW * s["deduped_windows"]) or any(
                    s["launches"].values()) or s["attention_fallbacks"]:
                raise AssertionError(f"{name} worker {wid}: tier {s['tier']}, "
                                     f"{s['steps_computed']} computed, {s['steps_accepted']} "
                                     f"accepted, {s['deduped_windows']} deduped windows, "
                                     f"launches {s['launches']}")
        losses = [w[2] for s in summaries.values() for w in s["windows"]]
        if not losses or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: window losses {losses}")
        return out


def phase_resnet_churn(tmp, uds):
    """`BASELINE.json`'s fifth config on bench_elastic.py's retention
    protocol (`bench_elastic.py:1-31`, `:161-250`), in the port's process
    mode on the card: resnet50_subclass in float32 as 4 active worker
    processes and 1 warm standby (`--num_standby_workers 1`), window mode
    (`--local_updates 2`, minibatch 64, tasks of 128), 8,192 synthetic
    records in 4 shards, 2 epochs, over shm. A stable run, then a churn
    run that SIGKILLs half of the live active workers at 25%, 50% and 75%
    of the records; images/s of each from its first completed task,
    retention = churn / stable. Checks, in each run: no failed task, every
    minibatch applied once (version = init + 256 = applied steps; a
    replayed window is deduped), each surviving worker's steps computed =
    accepted + its deduped windows' steps, every link on shm, finite
    losses, and no segment left once the workers are gone (the killed
    ones' too), before the server closes; in the churn run, all three
    waves fired, at least one promotion, every standby that stood by and
    was promoted had pre-warmed and none failed to. Prints the rates,
    relaunches, promotions and for each kill the seconds to the promoted
    standby's (or a replacement's) first accepted step. No retention
    figure is a target."""
    from elasticdl_tpu_torch.models.record_codec import write_synthetic_image_records

    data = os.path.join(tmp, "churn-data")
    os.makedirs(data)
    for i in range(4):
        write_synthetic_image_records(os.path.join(data, f"shard-{i}.rio"), CHURN_RECORDS // 4,
                                      IMAGENET_SHAPE, 10, seed=i)
    stable = churn_run(tmp, uds, data, "churn-stable", churn=False)
    if stable["promotions"] or stable["relaunches"]:
        raise AssertionError(f"stable run: {stable['promotions']} promotions, "
                             f"{stable['relaunches']} relaunches")
    run = churn_run(tmp, uds, data, "churn", churn=True)
    events = run["events"]
    warm = sorted(w for w, e in events.items() if e.get("standby") and e.get("promoted"))
    bad = [w for w in warm if not events[w].get("warm")]
    failed_warm = [w for w, e in events.items() if e.get("warm_failed")]
    if len(run["kills"]) != len(CHURN_WAVES) or run["promotions"] < 1 or not warm \
            or len(warm) > run["promotions"] or bad or failed_warm:
        raise AssertionError(f"churn: waves {len(run['kills'])}, promotions "
                             f"{run['promotions']}, promoted standbys {warm}, not pre-warmed "
                             f"{bad}, pre-warms failed {failed_warm}")
    retention = run["rate"] / stable["rate"]
    print(f"resnet churn (resnet50_subclass f32, {CHURN_WORKERS} active + {CHURN_STANDBY} "
          f"standby worker processes, W {CHURN_WINDOW}, minibatch {CHURN_BATCH}, "
          f"{CHURN_RECORDS} records x {CHURN_EPOCHS} epochs, shm): stable "
          f"{stable['rate']:.1f} images/s over {stable['elapsed']:.2f} s, churn "
          f"{run['rate']:.1f} images/s over {run['elapsed']:.2f} s, retention "
          f"{retention:.4f}; churn relaunches {run['relaunches']}, promotions "
          f"{run['promotions']}, warm promotions {len(warm)} of {run['promotions']} "
          f"(standbys that stood by and pre-warmed: {warm}, the rest promoted while still "
          f"booting); {os.cpu_count()} CPUs")
    for at, victims, alive, done in run["kills"]:
        nxt = [k[0] for k in run["kills"] if k[0] > at]
        until = nxt[0] if nxt else float("inf")
        # the workers whose first step landed between this kill and the
        # next: the promoted standbys (warm or still booting) and the
        # relaunched ones
        first = sorted((round(e["first_step"] - at, 3), w, "warm standby" if w in warm else
                        "cold") for w, e in events.items()
                       if at <= e.get("first_step", -1.0) < until)
        print(f"resnet churn kill at {done} records: SIGKILLed {victims} of {alive} live active "
              f"workers; first accepted steps after it (s from the kill, worker, how it "
              f"joined): {first}")
    for wid in sorted(events):
        e = events[wid]
        s = run["summaries"].get(wid)
        print(f"resnet churn worker {wid}: " + (
            f"{s['steps_accepted']} accepted, {s['steps_computed']} computed, "
            f"{s['deduped_windows']} deduped windows, pre-warm {s['standby_prewarm_seconds']:.2f} s"
            if s else "SIGKILLed (no summary)") + f"; log events {sorted(e)}")
    return {"stable": stable["rate"], "churn": run["rate"], "retention": retention,
            "warm_promotions": len(warm), "promotions": run["promotions"]}


# -- the sparse plane: BASELINE.json's deepfm_edl_embedding --------------------

DEEPFM_DEF = "deepfm_edl_embedding.custom_model"
DEEPFM_BATCH, DEEPFM_VOCAB = 128, 10000
DEEPFM_PER_STEP_RECORDS = 4096
# bench.py:553-590's sparse cell: W 16, b128, in tasks of W x 128; 8,192
# records (bench.py's 16,384, cut for the shard recovery phases' room)
DEEPFM_WINDOW, DEEPFM_WINDOW_RECORDS = 16, 8192
# the KV process job: most ids unseen, so the lazy init's SETNX carries the load
# (8,192 records, cut from 32,768, then 16,384, for the room the shard kill
# and the observability phases take)
DEEPFM_KV_RECORDS, DEEPFM_KV_VOCAB, DEEPFM_KV_EVAL = 8192, 1_000_000, 4096
# card vs CPU, norm-relative over each output: float32 both (TF32 off);
# the matmuls' and the BET gradient's scatter-add (atomic on the card)
# sum in other orders
DEEPFM_TOL = 1e-5


def deepfm_step(model, params, features, labels, embs, device):
    """One forward and backward of a deepfm model on `device`: (logits,
    flat dense gradient, {table: BET gradient}) as float64 numpy."""
    from elasticdl_tpu_torch.api.layers import EmbeddingInput
    from elasticdl_tpu_torch.common import codec
    from elasticdl_tpu_torch.convert import load_variables
    from elasticdl_tpu_torch.models.deepfm_edl_embedding import loss

    model = model.to(device)
    load_variables(model, params)
    x = {"ids": torch.from_numpy(features["ids"].astype(np.int64)).to(device)}
    bets, einp = {}, {}
    for name, b in (embs or {}).items():
        bets[name] = torch.from_numpy(b.bet.copy()).to(device).requires_grad_(True)
        einp[name] = EmbeddingInput(bets[name], torch.from_numpy(b.inverse).to(device),
                                    torch.from_numpy(b.mask).to(device))
    out = model(x, einp) if embs else model(x)
    names = [".".join(p) for p in codec.tree_paths(params)]
    leaves = [model.get_parameter(n) for n in names] + list(bets.values())
    grads = torch.autograd.grad(loss(out, torch.from_numpy(labels).to(device)), leaves)
    as_np = lambda t: t.detach().double().cpu().numpy()  # noqa: E731
    n = len(names)
    return (as_np(out), np.concatenate([as_np(g).ravel() for g in grads[:n]]),
            {k: as_np(g) for k, g in zip(bets, grads[n:])})


def phase_deepfm_models():
    """One train step of each deepfm model on the card against the same
    step on the CPU, from the same init and batch (b128, 10 fields; ids
    from a vocab of 10,000 for the elastic model, of its 5,500 for the
    in-model tables, with 0s as padding): the logits, the dense gradient
    and the BET gradients (elastic model) within DEEPFM_TOL, norm-relative."""
    from elasticdl_tpu_torch.api.layers import prepare_batch_embedding
    from elasticdl_tpu_torch.api.model_spec import get_model_spec

    failures = []
    for model_def, vocab in ((DEEPFM_DEF, DEEPFM_VOCAB), ("deepfm_functional_api.custom_model", 5500)):
        spec = get_model_spec(ZOO, model_def)
        rng = np.random.default_rng(0)
        ids = rng.integers(0, vocab, size=(DEEPFM_BATCH, spec.module.NUM_FIELDS))
        ids[rng.random(ids.shape) < 0.1] = 0
        features = {"ids": ids.astype(np.int32)}
        labels = (rng.random(DEEPFM_BATCH) < 0.5).astype(np.float32)
        embs = {s.name: prepare_batch_embedding(
            s, ids, lambda s, u: rng.uniform(-0.05, 0.05, (len(u), s.dim)).astype(np.float32))
            for s in spec.embedding_specs}
        params = spec.model.init_params(0)
        card = deepfm_step(spec.model, params, features, labels, embs, "cuda")
        cpu = deepfm_step(get_model_spec(ZOO, model_def).model, params, features, labels, embs, "cpu")
        pairs = [("logits", card[0], cpu[0]), ("grad", card[1], cpu[1])]
        pairs += [(f"bet_grad {k}", card[2][k], cpu[2][k]) for k in cpu[2]]
        errs = {}
        for what, got, want in pairs:
            errs[what] = float(np.linalg.norm(got - want) / np.linalg.norm(want))
            if not np.isfinite(got).all() or not errs[what] <= DEEPFM_TOL:
                failures.append(f"{model_def} {what}: card vs CPU {errs[what]:.3e}")
        print(f"deepfm model {model_def} (b{DEEPFM_BATCH}, {card[1].size:,} dense params): card "
              f"vs CPU norm-relative " + ", ".join(f"{w} {e:.3e}" for w, e in errs.items())
              + f" (limit {DEEPFM_TOL:.0e}, float32)")
    if failures:
        raise AssertionError("the deepfm models disagree between the card and the CPU:\n"
                             + "\n".join(failures))


def deepfm_records(path, n, vocab, seed=0):
    from elasticdl_tpu_torch.models.record_codec import write_synthetic_tabular_records

    if not os.path.exists(path):
        write_synthetic_tabular_records(path, n, 10, vocab, seed=seed)
    return path


def distinct_ids(paths) -> set:
    """The distinct non-zero ids of tabular record files."""
    from elasticdl_tpu_torch.data.recordio import RecordIOReader, count_records
    from elasticdl_tpu_torch.models.record_codec import decode_tabular_records

    seen = set()
    for path in paths:
        with RecordIOReader(path) as r:
            ids, _ = decode_tabular_records(list(r.read_range(0, count_records(path))), 10)
        seen |= set(ids[ids != 0].tolist())
    return seen


def deepfm_job(path, n_records, task_records, **worker_kw):
    """An in-process master/PS (the native store and the sparse Adam) and
    one deepfm_edl_embedding worker on the card; each lazy-init SETNX's
    rows are recorded (`inits`) to check that the rows moved."""
    from elasticdl_tpu_torch.api.model_spec import get_model_spec
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.testing import InProcessMaster, build_job
    from elasticdl_tpu_torch.worker.worker import Worker

    spec = get_model_spec(ZOO, DEEPFM_DEF)
    dispatcher = TaskDispatcher({path: n_records}, {}, {}, task_records, 1, shuffle_seed=0)
    servicer, _eval, _ckpt = build_job(spec, dispatcher, grads_to_wait=1)
    inits = {}

    def record_init(req):
        if req.get("set_if_not_exist"):
            for i, row in zip(req["ids"].tolist(), req["values"]):
                inits.setdefault((req["layer"], i), np.array(row))
        return req

    master = InProcessMaster(servicer, intercept={"EmbeddingUpdate": record_init})
    worker = Worker(0, master, spec, minibatch_size=DEEPFM_BATCH, device="cuda", seed=0,
                    **worker_kw)
    return dispatcher, servicer, master, worker, inits


def check_deepfm(what, ok, dispatcher, servicer, worker, steps, launches, fallbacks, seen,
                 inits=None):
    """The checks of every deepfm run: a clean finish, the exactness block,
    finite losses, 0 attention launches, the native store, one row per
    non-zero id seen in each table plus the Adam slot rows, and rows moved
    from their lazy init."""
    from elasticdl_tpu_torch.master.embedding_store import NativeEmbeddingStore

    ex = servicer.exactness()
    losses = ([loss for _t, loss in worker.step_log]
              + [loss for _t, _n, loss in worker.window_log] + list(worker.task_losses))
    if not ok or not dispatcher.finished():
        raise AssertionError(f"{what}: the job did not finish cleanly")
    if ex != {"version": steps, "init_version": 0, "applied_update_steps": steps}:
        raise AssertionError(f"{what}: exactness {ex}, {steps} steps applied once expected")
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: losses not finite: {losses}")
    if any(launches.values()) or fallbacks:
        raise AssertionError(f"{what}: attention launches {launches}, fallbacks {fallbacks}")
    store = servicer._embedding_store
    print(f"{what}: store {type(store).__name__}, {len(store)} rows")
    if not isinstance(store, NativeEmbeddingStore):
        raise AssertionError(f"{what}: the {type(store).__name__} served, not the native store")
    snap = store.snapshot()
    want = {t: len(seen) for t in ("fm_second", "fm_first", "fm_second/slot/m",
                                   "fm_second/slot/v", "fm_first/slot/m", "fm_first/slot/v")}
    got = {t: len(rows) for t, rows in snap.items()}
    if got != want:
        raise AssertionError(f"{what}: store rows by table {got}, {want} expected")
    if inits is not None:
        moved = sum(not np.array_equal(snap[t][i], row) for (t, i), row in inits.items())
        if len(inits) != 2 * len(seen) or moved < 0.99 * len(inits):
            raise AssertionError(f"{what}: {moved} of {len(inits)} lazily initialized rows moved")
    print(f"{what}: exactness {ex}, {len(seen)} distinct ids, rows by table {got}, "
          f"losses first / last {losses[0]:.4f} / {losses[-1]:.4f}, attention launches 0")


def phase_deepfm_per_step(fa, tmp):
    """deepfm_edl_embedding per-step in-process with the native store: b128,
    4,096 synthetic tabular records (seed 0) from a vocab of 10,000,
    grads_to_wait 1, 32 updates; `check_deepfm`, then records/s and the
    phase split (lookup with lazy init, compute, report) beside the
    master's sparse apply."""
    path = deepfm_records(os.path.join(tmp, "deepfm-per-step.rio"), DEEPFM_PER_STEP_RECORDS,
                          DEEPFM_VOCAB)
    steps = DEEPFM_PER_STEP_RECORDS // DEEPFM_BATCH
    dispatcher, servicer, master, worker, inits = deepfm_job(
        path, DEEPFM_PER_STEP_RECORDS, DEEPFM_BATCH * 8)
    reset_counts(fa)
    t0 = time.perf_counter()
    ok = worker.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fallbacks = read_counts(fa)
    worker.close()
    check_deepfm("deepfm per-step", ok, dispatcher, servicer, worker, steps, launches,
                 fallbacks, distinct_ids([path]), inits)
    times = [t for t, _loss in worker.step_log]
    print(f"deepfm per-step (b{DEEPFM_BATCH}, vocab {DEEPFM_VOCAB}): "
          f"{DEEPFM_PER_STEP_RECORDS / wall:.1f} records/s over the whole run ({wall:.2f} s), "
          f"{images_per_s(times, DEEPFM_BATCH):.1f} records/s over steps 2-{steps}; seconds a "
          f"step: " + ", ".join(f"{k} {v / steps:.5f}" for k, v in sorted(worker.phase_seconds.items()))
          + f", master sparse apply {servicer.sparse_apply_seconds / steps:.5f}, ReportGradient "
          f"handler {master.handler_seconds['ReportGradient'] / steps:.5f}, EmbeddingLookup "
          f"handler {master.handler_seconds['EmbeddingLookup'] / steps:.5f}; "
          f"{worker.lazy_init_rows} rows lazily initialized, "
          f"{worker.edl_gradient_bytes / steps:.0f} edl_gradient bytes a step")
    return launches


def deepfm_window_run(fa, path, what, env, profile=False):
    """One window run of the sparse cell under `env`: (records/s from the
    first to the last window sync, worker, servicer, master, profiler or
    None, the attention launch counts)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    steps = DEEPFM_WINDOW_RECORDS // DEEPFM_BATCH
    with environ(env):
        dispatcher, servicer, master, worker, _inits = deepfm_job(
            path, DEEPFM_WINDOW_RECORDS, DEEPFM_WINDOW * DEEPFM_BATCH,
            local_updates=DEEPFM_WINDOW)
        reset_counts(fa)
        prof = (torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profile
                else contextlib.nullcontext())
        with prof:
            ok = worker.run()
            torch.cuda.synchronize()
        launches, fallbacks = read_counts(fa)
        worker.close()
    check_deepfm(what, ok, dispatcher, servicer, worker, steps, launches, fallbacks,
                 distinct_ids([path]))
    if not math.isfinite(worker.task_losses[-1]):
        raise AssertionError(f"{what}: the tail loss is not finite")
    return (window_images_per_s(worker.window_log, DEEPFM_BATCH), worker, servicer, master,
            prof if profile else None, launches)


def phase_deepfm_window(fa, tmp):
    """bench.py:553-590's sparse cell: deepfm_edl_embedding in window mode,
    8,192 records from a vocab of 10,000, b128, W 16, tasks of W x 128
    (64 updates), BET prefetch off (EDL_BET_PREFETCH=0) and then on, in
    this call; each with `check_deepfm` and a finite tail loss. Prints
    the steady records/s of each, the sync split a sync with the
    edl_gradient bytes, and the device idle share of a third, profiled
    run (prefetch on)."""
    path = deepfm_records(os.path.join(tmp, "deepfm-window.rio"), DEEPFM_WINDOW_RECORDS,
                          DEEPFM_VOCAB)
    rates, counts = {}, []
    for prefetch in ("0", "1"):
        what = f"deepfm window prefetch {'on' if prefetch == '1' else 'off'}"
        rate, worker, servicer, master, _p, launches = deepfm_window_run(
            fa, path, what, {"EDL_BET_PREFETCH": prefetch})
        counts.append(launches)
        rates[prefetch] = rate
        syncs = len(worker.window_log)
        print(f"{what} (W {DEEPFM_WINDOW}, b{DEEPFM_BATCH}, {DEEPFM_WINDOW_RECORDS} records): "
              f"{rate:.1f} records/s from the first to the last window sync; sync seconds a "
              f"sync: " + ", ".join(f"{k} {v / syncs:.5f}" for k, v in sorted(worker.sync_seconds.items()))
              + f"; edl_gradient {worker.edl_gradient_bytes / syncs:.0f} bytes a sync; PS "
              f"(ReportLocalUpdate handler, sparse apply included) "
              f"{master.handler_seconds['ReportLocalUpdate'] / syncs:.5f} s a sync, sparse "
              f"apply {servicer.sparse_apply_seconds / syncs:.5f}; worker phases "
              f"{rounded(worker.phase_seconds)}")
    print(f"deepfm window: prefetch on / off {rates['1'] / rates['0']:.3f}x")
    launches = {k: sum(c[k] for c in counts) for k in counts[0]}
    _r, _w, _s, _m, prof, _l = deepfm_window_run(fa, path, "deepfm window profiled",
                                                 {"EDL_BET_PREFETCH": "1"}, profile=True)
    device = [(e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and "Sync" not in e.name]
    if not device:
        print("deepfm window profile: the profiler recorded no device time (not measured)")
        return launches
    first, last = min(s for s, _e in device), max(e for _s, e in device)
    t0 = first + (last - first) / 8  # past the first window (warm-up)
    busy = busy_us(device, t0, last)
    print(f"deepfm window profile (prefetch on): device busy {busy / 1e3:.2f} ms of "
          f"{(last - t0) / 1e3:.2f} ms over the last 7/8 of the device timeline (device idle "
          f"share {1 - busy / (last - t0):.3f})")
    return launches


def shard_processes(module="elasticdl_tpu_torch.master.kv_shard_main") -> list:
    """Pids of live shard processes of `module` (KV by default) on the host."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if module.encode() in f.read():
                    out.append(int(pid))
        except OSError:
            pass
    return out


def phase_deepfm_kv_process(tmp, uds):
    """master.main for deepfm_edl_embedding with `--num_kv_shards 2
    --kv_mode process` and 2 worker processes on the card, over
    EDL_TRANSPORT=shm: window mode (W 16, b128, tasks of W x 128),
    8,192 records from a vocab of 1,000,000 (most ids unseen: the SETNX
    path carries the load), one evaluation job with AUC at the end
    (4,096 records) and one checkpoint with the embeddings (at the last
    training version, before the evaluation's lookups). KV shard 1's
    process is SIGKILLed from outside once a quarter of the steps
    applied: the recovery plane relaunches it at generation 1 with the
    rows its ring pair (shard 0) mirrored. Checks rc 0 (every record
    completed), the exactness block, recoveries [("kv", 1, 1)] and
    nothing unrecoverable, 0 EmbeddingLookup and EmbeddingUpdate calls on
    the master (the workers go to the shards), every link (master and
    shards) on shm, native stores in both shards, the shards' rows (each
    table one row per distinct non-zero id seen, two Adam slot rows per
    id trained on; the mirror's staleness may lose the rows still queued
    at the kill, which come back only if their id is seen again, so no
    more rows than that and at most shard 1's rows not restored fewer),
    the AUC, the checkpoint's tables (within the same bound), 0 attention
    launches, and no shard process or segment left. Prints the rows
    restored from the pair and the recovery's seconds from the kill."""
    from elasticdl_tpu_torch.master.checkpoint import load_model_file
    from elasticdl_tpu_torch.worker.main import read_summaries

    train, evald = os.path.join(tmp, "deepfm-kv"), os.path.join(tmp, "deepfm-kv-eval")
    os.makedirs(train, exist_ok=True)
    os.makedirs(evald, exist_ok=True)
    half = DEEPFM_KV_RECORDS // 2
    shards = [deepfm_records(os.path.join(train, f"s{i}.rio"), half, DEEPFM_KV_VOCAB, seed=i)
              for i in range(2)]
    evals = [deepfm_records(os.path.join(evald, "e.rio"), DEEPFM_KV_EVAL, DEEPFM_KV_VOCAB, 7)]
    steps = DEEPFM_KV_RECORDS // DEEPFM_BATCH
    ckpt_dir, logs = os.path.join(tmp, "deepfm-kv-ckpt"), os.path.join(tmp, "deepfm-kv-logs")
    argv = ["--model_def", DEEPFM_DEF, "--minibatch_size", str(DEEPFM_BATCH),
            "--records_per_task", str(DEEPFM_WINDOW * DEEPFM_BATCH), "--num_workers", "2",
            "--worker_backend", "process", "--device", "cuda", "--grads_to_wait", "1",
            "--local_updates", str(DEEPFM_WINDOW), "--num_kv_shards", "2", "--kv_mode", "process",
            "--training_data_dir", train, "--evaluation_data_dir", evald,
            "--eval_steps", str(steps), "--checkpoint_dir", ckpt_dir,
            "--checkpoint_steps", str(steps)]
    box = {}

    def quarter_applied(servicer, group):
        return servicer.exactness()["applied_update_steps"] >= steps // 4

    rc, summary, wall = run_master(argv, logs, {"EDL_TRANSPORT": "shm"},
                                   on_start=shard_killer("kv", 1, quarter_applied, box))
    with logs_on_failure(logs):
        workers = read_summaries(logs)
        left = shard_processes()
        if rc != 0 or summary is None:
            raise AssertionError(f"deepfm kv process job: rc {rc}")
        tl = (summary["recovery_timelines"] or [{}])[0]
        restored = tl.get("rows_restored", 0)
        if "kill" in box and "active" in tl:
            print(f"deepfm kv process: KV shard 1 SIGKILLed once {steps // 4} steps applied, "
                  f"recoveries {summary['recoveries']}, generations "
                  f"{summary['generations']['kv']}, {restored} rows restored from the pair; "
                  f"{failover_seconds(tl, box['kill'])}")
        ex = {k: summary[k] for k in ("version", "init_version", "applied_update_steps")}
        calls = summary["server"]["calls"]
        sparse = summary["sparse"]
        print(f"deepfm kv process (2 KV shard processes, 2 workers, W {DEEPFM_WINDOW}, "
              f"b{DEEPFM_BATCH}, {DEEPFM_KV_RECORDS} records, vocab {DEEPFM_KV_VOCAB}, shm): rc {rc} "
              f"in {wall:.2f} s, exactness {ex}, master calls {calls}, sparse {sparse}, "
              f"evaluations {summary['evaluations']}")
        for wid, s in sorted(workers.items()):
            print(f"deepfm kv process worker {wid}: {s['device']}, master link {s['tier']}, KV "
                  f"links {s['kv_tiers']}, {s['steps_accepted']} steps, {s['lazy_init_rows']} rows "
                  f"lazily initialized, {s['edl_gradient_bytes']} edl_gradient bytes, phases "
                  f"{rounded(s['phase_seconds'])}, sync {rounded(s['sync_seconds'])}, client "
                  f"{rounded(s['rpc_seconds'])}, attention launches {sum(s['launches'].values())}")
        failures = check_failover(summary, "kv", 1, box)
        if ex != {"version": steps, "init_version": 0, "applied_update_steps": steps}:
            failures.append(f"exactness {ex}, {steps} steps applied once expected")
        if restored <= 0:
            failures.append("no row was restored from the pair")
        if calls.get("EmbeddingLookup", 0) or calls.get("EmbeddingUpdate", 0):
            failures.append("the master served embedding rows: the workers must go to the shards")
        if len(workers) != 2 or sum(s["steps_accepted"] for s in workers.values()) != steps:
            failures.append(f"{len(workers)} worker summaries, accepted steps "
                            f"{[s['steps_accepted'] for s in workers.values()]}")
        for s in workers.values():
            if s["tier"] != "shm" or s["kv_tiers"] != ["shm", "shm"]:
                failures.append(f"worker {s['worker_id']} links {s['tier']} / {s['kv_tiers']}, shm asked")
            if s["device"] == "cpu":
                failures.append(f"worker {s['worker_id']} ran on {s['device']}")
            if any(s["launches"].values()):
                failures.append(f"worker {s['worker_id']} launched attention kernels")
        if sparse["store"] != ["NativeEmbeddingStore"] * 2:
            failures.append(f"the shards' stores {sparse['store']}, native expected")
        seen, trained = distinct_ids(shards + evals), distinct_ids(shards)
        want = 2 * len(seen) + 4 * len(trained)
        # the rows shard 1 could hold that were not restored bound the loss
        odd = 2 * sum(i % 2 for i in seen) + 4 * sum(i % 2 for i in trained)
        lost_bound = max(0, odd - restored)
        rows = sum(sparse["rows"])
        print(f"deepfm kv process rows: {rows} of {want} ({want - rows} lost with the mirror's "
              f"queue at the kill; at most {lost_bound})")
        if not want - lost_bound <= rows <= want:
            failures.append(f"the shards hold {rows} rows; {2 * len(seen)} rows of "
                            f"{len(seen)} ids and {4 * len(trained)} slot rows expected, "
                            f"at most {lost_bound} of them lost")
        evaluations = summary["evaluations"]
        if len(evaluations) != 1 or not 0.0 <= evaluations[0][1].get("auc", -1) <= 1.0:
            failures.append(f"evaluations {evaluations}: one job with an AUC expected")
        ckpts = sorted(os.listdir(ckpt_dir)) if os.path.isdir(ckpt_dir) else []
        if ckpts != [f"model_v{steps}.ckpt"]:
            failures.append(f"checkpoints {ckpts}, model_v{steps}.ckpt expected")
        else:
            model = load_model_file(os.path.join(ckpt_dir, ckpts[0]))
            emb = model.embeddings or {}
            # taken at the last training version, before the evaluation's lookups
            tables = ("fm_second", "fm_first", "fm_second/slot/m", "fm_second/slot/v",
                      "fm_first/slot/m", "fm_first/slot/v")
            counts = {t: len(r) for t, r in emb.items()}
            missing = sum(len(trained) - counts.get(t, 0) for t in tables)
            if (set(counts) != set(tables) or any(counts[t] > len(trained) for t in tables)
                    or missing > lost_bound):
                failures.append(f"the checkpoint's tables {counts} are not the trained rows "
                                f"and slots ({len(trained)} each, at most {lost_bound} lost)")
            print(f"deepfm kv process checkpoint: v{model.version}, tables "
                  f"{ {t: len(r) for t, r in emb.items()} }")
        if left:
            failures.append(f"KV shard processes left: {left}")
        segments = [n for n in os.listdir("/dev/shm") if n.startswith("edltshm.")]
        if segments:
            failures.append(f"shm segments left: {segments}")
        if failures:
            raise AssertionError("deepfm kv process job:\n" + "\n".join(failures))
        return summed_launches(workers)


def timed(phase, *args):
    """Run one phase and print its wall-clock seconds."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    started = time.perf_counter()
    from elasticdl_tpu_torch.ops import build
    from elasticdl_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from elasticdl_tpu_torch.master import embedding_store

    # the kernels (nvcc) and the native embedding store (host C++, g++), each
    # from the checkout's source in this run, the two compilers started together
    for lib in (build.library_path("flash_attention"), embedding_store.library_path()):
        if os.path.exists(lib):
            os.remove(lib)

    def build_seconds(fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=2) as pool:
        builds = {"flash_attention.cu": pool.submit(build_seconds, build.build, "flash_attention"),
                  "embedding_store.cc": pool.submit(build_seconds, embedding_store.build_native)}
        for source, seconds in builds.items():
            print(f"built {source} in {seconds.result():.2f} s")
    with open(os.path.join(build.BUILD_DIR, "flash_attention.log")) as f:
        registers = check_ptxas(f.read())

    rows, pairs = timed(phase_kernels, fa)
    timed(phase_model_reference)
    timed(phase_moe_reference)
    with tempfile.TemporaryDirectory() as tmp:
        counts = {}
        counts["launches"] = timed(phase_train, fa, tmp)
        timed(phase_profile, tmp)
        counts["window_launches"] = timed(phase_window, fa, tmp)
        timed(phase_window_profile, tmp)
        counts["ladder_adaptive_launches"] = timed(phase_window_ladder_adaptive, fa, tmp)
        timed(phase_ef_card, slice_param_count())
        counts.update(timed(phase_zoo_default, fa, tmp))
        timed(phase_zoo_head_dim8, fa, tmp)
        counts["large_launches"], counts["large_window_launches"] = timed(phase_large, fa, tmp)
        counts["xl_launches"], counts["xl_window_launches"] = timed(phase_xl, fa, tmp)
        counts["moe_launches"], counts["moe_window_launches"] = timed(phase_moe, fa, tmp)
        timed(phase_image_models)
        timed(phase_image_per_step, fa, tmp)
        timed(phase_cifar_window, fa, tmp)
        timed(phase_resnet_window, fa, tmp)
        eval_counts = timed(phase_eval_kernels, fa, tmp)
        timed(phase_resume, tmp)
        torch.cuda.empty_cache()  # leave the card's memory to the workers
        counts["process_launches"] = timed(phase_process_job, tmp)
        counts["zoo_process_launches"] = timed(phase_process_job, tmp, "zoo-process", "")
        timed(phase_preemption, tmp)
        counts["window_process_launches"] = timed(phase_window_process_job, tmp)
        counts["large_window_process_launches"] = timed(
            phase_window_process_job, tmp, "large window process", LARGE_PARAMS, LARGE_BATCH,
            LARGE_BATCH * WINDOW, 2)
        counts["xl_sharded_process_launches"] = timed(phase_xl_sharded_processes, tmp)
        counts["sharded_async_launches"] = timed(phase_sharded_async, tmp)
        counts["sharded_async_depth0_launches"] = timed(phase_sharded_async, tmp, 0)
        print(f"sharded async A/B (this call, same job): depth {DEFAULT_ASYNC_DEPTH} "
              f"{SHARDED_ASYNC_RATES[DEFAULT_ASYNC_DEPTH]:.1f} tokens/s, depth 0 "
              f"{SHARDED_ASYNC_RATES[0]:.1f} tokens/s, ratio "
              f"{SHARDED_ASYNC_RATES[DEFAULT_ASYNC_DEPTH] / SHARDED_ASYNC_RATES[0]:.3f}")
        counts["shard_failover_launches"] = timed(phase_shard_failover, tmp)
        counts["chaos_launches"] = timed(phase_chaos, tmp)
        counts["obs_critical_path_launches"] = timed(phase_obs_critical_path, fa, tmp)
        counts["obs_processes_launches"] = timed(phase_obs_processes, tmp)
        if not any(pulls for pulls, _applied in PAGE_IN.values()):
            raise AssertionError(f"no 2-worker window phase paged a model in: {PAGE_IN}")
        timed(phase_window_drain, tmp)
        timed(phase_image_process_job, tmp)
        async_job = timed(phase_async_process_job, tmp)
        timed(phase_standalone_eval_predict, fa, tmp, async_job)
        with tier_dir() as uds:
            timed(phase_transport_probe, uds)
            timed(phase_imagenet_async, tmp, uds)
            timed(phase_resnet_churn, tmp, uds)
            # the sparse plane: no attention on any deepfm path
            timed(phase_deepfm_models)
            deepfm_counts = {
                "deepfm_launches": timed(phase_deepfm_per_step, fa, tmp),
                "deepfm_window_launches": timed(phase_deepfm_window, fa, tmp),
                "deepfm_kv_process_launches": timed(phase_deepfm_kv_process, tmp, uds),
            }
    # each row's counts are its own kernel's at its own head dim, per path
    # of its dtype (the wrappers count by head dim; a path runs one dtype)
    for by_kernel in rows.values():
        for kernel, row in by_kernel.items():
            paths = [p for p in counts if (p in FLOAT32_PATHS) == (row["dtype"] == "float32")]
            for path in paths:
                row[path] = counts[path][f"{kernel}_d{row['head_dim']}"]
            # `launches`: the row's main path; at 32, which no path of the
            # repo runs, every path's count summed (0)
            main_path = MAIN_PATH.get((row["dtype"], row["head_dim"]))
            row["launches"] = row[main_path] if main_path else sum(row[p] for p in paths)
            # the evaluation forward's launches, by the row's dtype
            row["eval_launches"] = eval_counts[row["dtype"]][f"{kernel}_d{row['head_dim']}"]
            # the deepfm paths run no attention: 0 on every row
            for path, c in deepfm_counts.items():
                row[path] = c[f"{kernel}_d{row['head_dim']}"]
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s from the start to the kernels' line")
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

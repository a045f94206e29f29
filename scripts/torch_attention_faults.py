"""Plant known faults in a copy of the attention kernels and show that
chip_smoke.py's gradient checks catch each, on one CUDA card.

    python3 scripts/torch_attention_faults.py [--work DIR]

chip_smoke.py holds the bf16 dq and dk+dv kernels to BF16_TOL plus two
bf16 rounding flips of a row's largest term (`exact_backward`), and to
a root mean square distance from the float64 function of at most
BF16_RMS_RATIO times the plain version's; it holds the float32 kernels
(forward, dq, dk+dv) to F32_TOL (atol = rtol = 1e-5). This script
measures what those checks catch. For each entry of FAULTS it copies
`ops/csrc/flash_attention.cu` into DIR (a new temporary directory by
default), replaces one line of it (the fault), builds the copy with
`ops/build.py`'s nvcc flags (all copies at once), loads it in place of
the repo's library, and runs chip_smoke.py's checks at every shape of
`KERNEL_CHECKS` in the fault's dtype (first seed, each causal case): in
bf16 `backward_errs` on the plain forward's lse, in float32
`kernel_checks` (the forward's o and lse, then the backward on the plain
forward's lse and o and on the kernel's own). The first entry plants
nothing and is checked in both dtypes. Per fault and shape it prints the
largest share of the element limit that the forward's o and lse (float32)
and dq, dk and dv use and the checks that failed (`backward_errs` prints
the bf16 rms ratios). Exits 1 if the copy with nothing planted fails or a
fault passes every check.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from elasticdl_tpu_torch.ops import build  # noqa: E402
from elasticdl_tpu_torch.ops import flash_attention as fa  # noqa: E402

BF16, F32 = (torch.bfloat16,), (torch.float32,)
# name: (dtypes checked, (line of the source, what replaces it)); each
# line occurs once
FAULTS = {
    "none": (BF16 + F32, None),
    # the first block to be dispatched (the last q tile when causal) skips
    # k tile 0 in dq
    "dq_drops_a_k_tile": (BF16, (
        "    const bf16* Kt = Ks + st * TILE;\n",
        "    if (blockIdx.y == 0 && kt == 0 && n_k > 1) continue;\n"
        "    const bf16* Kt = Ks + st * TILE;\n",
    )),
    # dq masks the diagonal (q == k) as well
    "dq_masks_the_diagonal": (BF16, (
        "if (part && w0 + row + (e >> 1) * 8 < kc + j * 8 + col + (e & 1)) p = 0.f;",
        "if (part && w0 + row + (e >> 1) * 8 <= kc + j * 8 + col + (e & 1)) p = 0.f;",
    )),
    # dk+dv forms ds without the 1/sqrt(D) scale
    "dkv_ds_unscaled": (BF16, (
        "dst[j][e] = p * (dst[j][e] - dq) * scale;",
        "dst[j][e] = p * (dst[j][e] - dq);",
    )),
    # dq rounds dp = do.v^T to bf16 before ds
    "dq_dp_rounded_to_bf16": (BF16, (
        "s[j][e] = p * (dp[j][e] - dl[e >> 1]) * scale;",
        "s[j][e] = p * (__bfloat162float(__float2bfloat16(dp[j][e])) - dl[e >> 1]) * scale;",
    )),
    # dk+dv rounds dp^T to bf16 before ds^T
    "dkv_dp_rounded_to_bf16": (BF16, (
        "dst[j][e] = p * (dst[j][e] - dq) * scale;",
        "dst[j][e] = p * (__bfloat162float(__float2bfloat16(dst[j][e])) - dq) * scale;",
    )),
    # f32 dq and dk+dv: the last group's partial sums are left out of the
    # final sum (at the head dims whose blocks split the streamed tiles)
    "f32_split_partial_dropped": (F32, (
        "    for (int p = 0; p < S - 1; ++p)\n",
        "    for (int p = 0; p < S - 2; ++p)\n",
    )),
    # f32 dk+dv: each warp's causal walk starts one q row late, so its
    # first k row misses its diagonal pair
    "f32_dkv_causal_start_late": (F32, (
        "        ra = max(ra, w0 - q0);\n",
        "        ra = max(ra, w0 - q0 + 1);\n",
    )),
    # f32 dk+dv: ds = p dp, delta not subtracted
    "f32_dkv_delta_not_subtracted": (F32, (
        "const float ds = p * (dp[i] - dq);",
        "const float ds = p * dp[i];",
    )),
    # f32 dq: lse taken as base 2 without the log2(e) fold
    "f32_dq_lse_log2e_missing": (F32, (
        "      lse2[i] = lse[(size_t)bh * L + r] * LOG2E;\n",
        "      lse2[i] = lse[(size_t)bh * L + r];\n",
    )),
    # f32 forward: the last group's partial (m, l, acc) is left out of the
    # merge (every head dim's blocks split the streamed tiles)
    "f32_fwd_group_partial_dropped": (F32, (
        "    for (int p = 1; p < S; ++p) {\n",
        "    for (int p = 1; p < S - 1; ++p) {\n",
    )),
    # f32 forward: a step's new max rescales l but not acc
    "f32_fwd_correction_not_applied": (F32, (
        "    for (int e = 0; e < DL; ++e) acc[i][e] *= corr;  // the step's correction\n",
        "",
    )),
    # f32 forward: lse written in base 2, without the ln 2
    "f32_fwd_lse_base2": (F32, (
        "lse[(size_t)bh * L + r] = (m[i] + log2f(l[i])) * LN2;",
        "lse[(size_t)bh * L + r] = m[i] + log2f(l[i]);",
    )),
    # f32 forward: the causal compare one column off, so the diagonal
    # (k == q) is masked too
    "f32_fwd_diagonal_masked": (F32, (
        "kp + c > qp + i * (32 / R)",
        "kp + c >= qp + i * (32 / R)",
    )),
}


def build_copy(work: str, name: str, fault, source=None) -> str:
    """The kernel source (`source`, by default the tree's) with `fault`
    planted, built into `work` (the compiler's output beside it as
    `<name>.log`); returns the library's path."""
    with open(source or os.path.join(build.CSRC_DIR, "flash_attention.cu")) as f:
        src = f.read()
    if fault is not None:
        old, new = fault
        if src.count(old) != 1:
            raise AssertionError(f"{name}: the line to replace occurs {src.count(old)} times")
        src = src.replace(old, new)
    path = os.path.join(work, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(work, f"lib{name}.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    with open(os.path.join(work, f"{name}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    return lib


def check(name: str, dtypes) -> bool:
    """chip_smoke.py's checks at every shape of KERNEL_CHECKS in `dtypes`
    (bf16: the backward's; float32: the forward's and the backward's);
    prints the readings and returns whether any check failed."""
    caught = False
    for dtype, shape, d, causals, seeds in cs.KERNEL_CHECKS:
        if dtype not in dtypes:
            continue
        q, k, v, do = cs.attention_inputs(*shape, d, dtype, seed=seeds[0])
        for causal in causals:
            failures = []
            tag = f"{name} {tuple(q.shape)} causal={causal}"
            if dtype == torch.float32:
                readings = cs.kernel_checks(fa, q, k, v, do, causal, tag, failures)[2]
                kernels, outputs = cs.KERNELS, "(o, lse, dq, dk, dv)"
            else:
                o, lse = fa.plain_forward(q, k, v, causal)
                readings = cs.backward_errs(fa, q, k, v, do, lse, fa.attention_delta(do, o),
                                            causal, cs.TOLS[dtype], tag, failures)
                kernels, outputs = cs.KERNELS[1:], "(dq, dk, dv)"
                del o, lse
            shares = [round(s, 3) for n in kernels for _err, s in readings[n]]
            print(f"{tag}: {outputs} shares of the element limit {shares}; "
                  + (f"FAILS: {'; '.join(failures)}" if failures else "passes"), flush=True)
            caught |= bool(failures)
        del q, k, v, do
        torch.cuda.empty_cache()
    return caught


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--work", default=None, help="directory for the copies (default: new)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    work = args.work or tempfile.mkdtemp(prefix="attention-faults-")
    os.makedirs(work, exist_ok=True)
    with ThreadPoolExecutor(len(FAULTS)) as pool:
        libs = dict(zip(FAULTS, pool.map(
            lambda name: build_copy(work, name, FAULTS[name][1]), FAULTS)))
    escaped = []
    for name, (dtypes, fault) in FAULTS.items():
        build.load = lambda _name, lib=libs[name]: ctypes.CDLL(lib)
        fa._lib.cache_clear()
        caught = check(name, dtypes)
        if caught != (fault is not None):
            escaped.append(name)
    print(f"faults not caught (or a false alarm for 'none'): {escaped}")
    return 1 if escaped else 0


if __name__ == "__main__":
    sys.exit(main())

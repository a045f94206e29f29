"""Plant known faults in a copy of the attention kernels and show that
chip_smoke.py's bf16 gradient checks catch each, on one CUDA card.

    python3 scripts/torch_attention_faults.py [--work DIR]

chip_smoke.py holds the bf16 dq and dk+dv kernels to BF16_TOL plus two
bf16 rounding flips of a row's largest term (`exact_backward`), and to
a root mean square distance from the float64 function of at most
BF16_RMS_RATIO times the plain version's. This script measures what
those checks catch. For each entry of FAULTS it copies
`ops/csrc/flash_attention.cu` into DIR (a new temporary directory by
default), replaces one line of it (the fault), builds the copy with
`ops/build.py`'s nvcc flags, loads it in place of the repo's library,
and runs chip_smoke.py's `backward_errs` on the plain forward's lse at
every bfloat16 shape of `KERNEL_CHECKS` (first seed, each causal case).
The first entry plants nothing. Per fault and shape it prints the
largest share of the element limit that dq, dk and dv use and the
checks that failed (`backward_errs` prints the rms ratios). Exits 1 if
the copy with nothing planted fails or a fault passes every check.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from elasticdl_tpu_torch.ops import build  # noqa: E402
from elasticdl_tpu_torch.ops import flash_attention as fa  # noqa: E402

# name: (line of the source, what replaces it); each line occurs once
FAULTS = {
    "none": None,
    # the first block to be dispatched (the last q tile when causal) skips
    # k tile 0 in dq
    "dq_drops_a_k_tile": (
        "    const bf16* Kt = Ks + st * TILE;\n",
        "    if (blockIdx.y == 0 && kt == 0 && n_k > 1) continue;\n"
        "    const bf16* Kt = Ks + st * TILE;\n",
    ),
    # dq masks the diagonal (q == k) as well
    "dq_masks_the_diagonal": (
        "if (part && w0 + row + (e >> 1) * 8 < kc + j * 8 + col + (e & 1)) p = 0.f;",
        "if (part && w0 + row + (e >> 1) * 8 <= kc + j * 8 + col + (e & 1)) p = 0.f;",
    ),
    # dk+dv forms ds without the 1/sqrt(D) scale
    "dkv_ds_unscaled": (
        "dst[j][e] = p * (dst[j][e] - dq) * scale;",
        "dst[j][e] = p * (dst[j][e] - dq);",
    ),
    # dq rounds dp = do.v^T to bf16 before ds
    "dq_dp_rounded_to_bf16": (
        "s[j][e] = p * (dp[j][e] - dl[e >> 1]) * scale;",
        "s[j][e] = p * (__bfloat162float(__float2bfloat16(dp[j][e])) - dl[e >> 1]) * scale;",
    ),
    # dk+dv rounds dp^T to bf16 before ds^T
    "dkv_dp_rounded_to_bf16": (
        "dst[j][e] = p * (dst[j][e] - dq) * scale;",
        "dst[j][e] = p * (__bfloat162float(__float2bfloat16(dst[j][e])) - dq) * scale;",
    ),
}


def build_copy(work: str, name: str, fault) -> str:
    """The kernel source with `fault` planted, built into `work`; returns
    the library's path."""
    with open(os.path.join(build.CSRC_DIR, "flash_attention.cu")) as f:
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
    return lib


def check(name: str) -> bool:
    """chip_smoke.py's bf16 backward checks at every bf16 shape; prints
    the readings and returns whether any check failed."""
    caught = False
    for dtype, shape, d, causals, seeds in cs.KERNEL_CHECKS:
        if dtype != torch.bfloat16:
            continue
        q, k, v, do = cs.attention_inputs(*shape, d, dtype, seed=seeds[0])
        for causal in causals:
            o, lse = fa.plain_forward(q, k, v, causal)
            delta = fa.attention_delta(do, o)
            failures = []
            tag = f"{name} {tuple(q.shape)} causal={causal}"
            readings = cs.backward_errs(fa, q, k, v, do, lse, delta, causal, cs.TOLS[dtype],
                                        tag, failures)
            shares = [round(s, 3) for r in (readings["flash_dq"], readings["flash_dkv"])
                      for _err, s in r]
            print(f"{tag}: (dq, dk, dv) shares of the element limit {shares}; "
                  + (f"FAILS: {'; '.join(failures)}" if failures else "passes"), flush=True)
            caught |= bool(failures)
            del o, lse, delta
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
    escaped = []
    for name, fault in FAULTS.items():
        lib = build_copy(work, name, fault)
        build.load = lambda _name, lib=lib: ctypes.CDLL(lib)
        fa._lib.cache_clear()
        caught = check(name)
        if caught != (fault is not None):
            escaped.append(name)
    print(f"faults not caught (or a false alarm for 'none'): {escaped}")
    return 1 if escaped else 0


if __name__ == "__main__":
    sys.exit(main())

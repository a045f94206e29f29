"""Time the float32 attention kernels (forward, dq, dk+dv) of a baseline
source against the tree's, in turns, on one CUDA card.

    python3 scripts/torch_attention_f32_turns.py --baseline PARENT.cu [--work DIR]
        [--head-dims 16,32] [--tiling "D,W=..." ...]

BASELINE is a copy of `ops/csrc/flash_attention.cu` saved outside the repo
(the parent commit's, or a variant). Each `--tiling` adds a copy of the
tree's source with one head dim's tiling replaced: "D,0=MR,S,TS,STAGES,C"
sets the forward's `fc<D>()`, "D,W=S,TS,STAGES,AHEAD" (W: 1 dq, 2 dk+dv)
the backward's `cc<D, W>()`. This script builds them all and
the tree's source with `ops/build.py`'s nvcc flags into DIR (a new
temporary directory by default; `torch_attention_faults.build_copy`, all
at once), prints ptxas's registers and spills of each one's f32 kernels
and the blocks an SM holds, and holds each one's f32 kernels against
their plain versions under chip_smoke.py's F32_TOL at every float32 shape
of chip_smoke.py's KERNEL_CHECKS and at SHAPES (causal):
chip_smoke.py's `kernel_checks`, `flash_forward` (o, lse) against
`plain_forward`, then `flash_dq` and `flash_dkv` on the plain forward's
lse and o and on the kernel's own. Then at each shape of SHAPES (float32,
causal) it times the forward, dq, dk+dv, the backward triple
(attention_delta + dq + dk+dv) and the whole f32 attention (forward +
the triple) of all in turns, baseline, tree, tilings, then back (a, b,
..., b, a), and prints each time and the ratio of each one's mean to the
baseline's. Exits 1 if a kernel disagrees with its plain version.
"""

import argparse
import ctypes
import os
import re
import statistics
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as cs  # noqa: E402
from elasticdl_tpu_torch.ops import build  # noqa: E402
from elasticdl_tpu_torch.ops import flash_attention as fa  # noqa: E402
from torch_attention_faults import build_copy  # noqa: E402

# (B, L, H, D) timed: the zoo default's (4 heads of 16) and, at 32, 64 and
# 128, the bf16 rows' shapes of chip_smoke.py's kernels line
SHAPES = ((8, 1024, 4, 16), (8, 1024, 16, 32), (8, 1024, 8, 64), (16, 1024, 8, 128))
F32_KERNELS = ("fa_fwd_kernel", "fa_dq_kernel", "fa_dkv_kernel")


def tiling_edit(spec):
    """(line to replace, replacement) of the tree's source for `spec`,
    "D,0=MR,S,TS,STAGES,C" (the forward) or "D,W=S,TS,STAGES,AHEAD"."""
    (d, w), shape = (x.split(",") for x in spec.split("="))
    with open(os.path.join(build.CSRC_DIR, "flash_attention.cu")) as f:
        src = f.read()
    table = f"fc<{int(d)}>" if int(w) == 0 else f"cc<{int(d)}, {int(w)}>"
    old = re.search(rf"{table}\(\) {{ return {{[^}}]*}}; }}", src).group(0)
    return old, re.sub(r"return \{[^}]*\}", "return {" + ", ".join(shape) + "}", old)


def ptxas_lines(work, name):
    """ptxas's register and spill lines of the f32 kernels."""
    out, kernel = [], None
    with open(os.path.join(work, f"{name}.log")) as f:
        for line in f:
            if "Compiling entry function" in line:
                kernel = re.search(r"(fa_(?:fwd|dq|dkv)(?:_bf16)?_kernel)ILi(\d+)E", line)
            elif kernel and kernel.group(1) in F32_KERNELS and ("registers" in line
                                                                 or "spill" in line):
                out.append(f"{name} {kernel.group(1)}<{kernel.group(2)}>: "
                           f"{line.split(':', 1)[-1].strip()}")
    return out


def use(lib):
    """Route the wrappers' launches to the library at `lib`."""
    build.load = lambda _name: ctypes.CDLL(lib)
    fa._lib.cache_clear()


def checked(name, head_dims):
    """The f32 kernels against their plain versions (chip_smoke.py's
    `kernel_checks`); returns the failures."""
    failures = []
    cases = [(shape, d, causals) for dtype, shape, d, causals, _seeds in cs.KERNEL_CHECKS
             if dtype == torch.float32 and d in head_dims]
    cases += [(s[:3], s[3], (True,)) for s in SHAPES if s[3] in head_dims]
    for shape, d, causals in cases:
        q, k, v, do = cs.attention_inputs(*shape, d, torch.float32, seed=1)
        for causal in causals:
            cs.kernel_checks(fa, q, k, v, do, causal, f"{name} {tuple(q.shape)} causal={causal}",
                             failures)
    return failures


WHAT = ("forward", "dq", "dk+dv", "attention_delta + dq + dk+dv",
        "forward + attention_delta + dq + dk+dv")


def times(shape):
    """ms of each of WHAT at `shape`, f32, causal (the backward on the
    plain forward's lse and o)."""
    q, k, v, do = cs.attention_inputs(*shape, torch.float32, seed=1)
    o, lse = fa.plain_forward(q, k, v, True)
    delta = fa.attention_delta(do, o)

    def triple(o, lse):
        dd = fa.attention_delta(do, o)
        fa.flash_dq(q, k, v, do, lse, dd, True)
        fa.flash_dkv(q, k, v, do, lse, dd, True)

    return (cs.time_ms(lambda: fa.flash_forward(q, k, v, True)),
            cs.time_ms(lambda: fa.flash_dq(q, k, v, do, lse, delta, True)),
            cs.time_ms(lambda: fa.flash_dkv(q, k, v, do, lse, delta, True)),
            cs.time_ms(lambda: triple(o, lse)),
            cs.time_ms(lambda: triple(*fa.flash_forward(q, k, v, True))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", required=True, help="baseline flash_attention.cu")
    parser.add_argument("--work", default=None, help="directory for the builds (default: new)")
    parser.add_argument("--head-dims", default="16,32,64,128",
                        help="head dims to check and time (default: all)")
    parser.add_argument("--tiling", action="append", default=[],
                        help='a variant of the tree: "D,0=MR,S,TS,STAGES,C" (forward) '
                             'or "D,W=S,TS,STAGES,AHEAD" (W: 1 dq, 2 dk+dv)')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    head_dims = [int(d) for d in args.head_dims.split(",")]
    work = args.work or tempfile.mkdtemp(prefix="attention-f32-turns-")
    os.makedirs(work, exist_ok=True)
    tree = os.path.join(build.CSRC_DIR, "flash_attention.cu")
    copies = {"baseline": (os.path.abspath(args.baseline), None), "tree": (tree, None)}
    for i, spec in enumerate(args.tiling):
        print(f"tiling{i}: {spec}")
        copies[f"tiling{i}"] = (tree, tiling_edit(spec))
    with ThreadPoolExecutor(len(copies)) as pool:
        libs = dict(zip(copies, pool.map(
            lambda n: build_copy(work, n, copies[n][1], copies[n][0]), copies)))
    wrong = []
    for name, lib in libs.items():
        print("\n".join(ptxas_lines(work, name)))
        use(lib)
        print(f"{name} blocks an SM (forward, dq, dk+dv) by head dim: " + ", ".join(
            f"{d}: {[fa.blocks_per_sm(k, d, torch.float32) for k in cs.KERNELS]}"
            for d in head_dims), flush=True)
        if checked(name, head_dims):
            wrong.append(name)
    for shape in (s for s in SHAPES if s[3] in head_dims):
        readings = {n: [] for n in libs}
        for name in list(libs) + list(libs)[::-1]:
            use(libs[name])
            readings[name].append(times(shape))
        for i, what in enumerate(WHAT):
            base = statistics.mean(r[i] for r in readings["baseline"])
            print(f"{list(shape)} f32 causal {what}: " + "; ".join(
                f"{n} ms {[round(r[i], 4) for r in rs]}"
                + ("" if n == "baseline" else f", {n} / baseline "
                   f"{statistics.mean(r[i] for r in rs) / base:.3f}")
                for n, rs in readings.items()), flush=True)
    print(f"builds whose kernels disagree with their plain versions: {wrong}")
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())

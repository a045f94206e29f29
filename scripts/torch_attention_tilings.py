"""Time tilings of the bf16 attention kernels at head dims 16 and 32 on one
CUDA card, to choose `Tc<16>` and `Tc<32>` in ops/csrc/flash_attention.cu.

    python3 scripts/torch_attention_tilings.py [--work DIR]

`Tc<D>` sets the tensor-core kernels' tiling at head dim D: STAGES, the
depth of the cp.async ring of streamed tiles, and FWD_MT, the forward's
16-row q tiles a warp. For each (D, STAGES, FWD_MT) of TILINGS this script
builds a copy of the source with that tiling in DIR (a new temporary
directory by default; `torch_attention_faults.build_copy`, all copies at
once), prints ptxas's registers and spills of its bf16 kernels at D and
the blocks an SM holds, holds its three kernels against their plain
versions at D's timed shape (chip_smoke.py's TIMED_16 or TIMED_32, bf16,
causal) under chip_smoke.py's limits, and times them there. Each head
dim's tilings are timed in turns, first to last and back (a, b, ..., b,
a); the line per tiling gives both times of each kernel. Exits 1 if a
tiling's kernels disagree with their plain versions.
"""

import argparse
import ctypes
import os
import re
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

# (head dim, STAGES, FWD_MT); the source's own tiling of each head dim is
# one of them
TILINGS = (
    (16, 2, 2), (16, 3, 2), (16, 4, 2), (16, 2, 4),
    (32, 2, 2), (32, 3, 2), (32, 4, 2), (32, 3, 4),
)
TIMED = {16: cs.TIMED_16, 32: cs.TIMED_32}


def tiling_edit(d, stages, fwd_mt):
    """(line to replace, replacement): the source's `Tc<d>` STAGES and
    FWD_MT set to `stages` and `fwd_mt`."""
    with open(os.path.join(build.CSRC_DIR, "flash_attention.cu")) as f:
        src = f.read()
    old = re.search(rf"struct Tc<{d}> {{\n  static constexpr int STAGES = \d+;.*\n"
                    r"  static constexpr int FWD_MT = \d+;", src).group(0)
    new = re.sub(r"STAGES = \d+", f"STAGES = {stages}", old)
    return old, re.sub(r"FWD_MT = \d+", f"FWD_MT = {fwd_mt}", new)


def ptxas_lines(work, name, d):
    """ptxas's register and spill lines of the bf16 kernels at head dim d."""
    out, kernel = [], None
    with open(os.path.join(work, f"{name}.log")) as f:
        for line in f:
            if "Compiling entry function" in line:
                kernel = re.search(r"(fa_\w+_bf16_kernel)ILi(\d+)E", line)
            elif kernel and int(kernel.group(2)) == d and ("registers" in line
                                                           or "spill" in line):
                out.append(f"{kernel.group(1)}<{d}>: {line.split(':', 1)[-1].strip()}")
    return out


def checked(name, d):
    """The kernels against their plain versions at d's timed shape
    (forward under BF16_TOL, dq and dk+dv by chip_smoke's backward_errs);
    returns the failures."""
    failures = []
    q, k, v, do = cs.attention_inputs(*TIMED[d], d, torch.bfloat16, seed=1)
    o, lse = fa.flash_forward(q, k, v, True)
    po, plse = fa.plain_forward(q, k, v, True)
    cs.check_close(f"{name} forward", (o, lse), (po, plse),
                   (cs.BF16_TOL["o"], cs.BF16_TOL["lse"]), failures)
    cs.backward_errs(fa, q, k, v, do, plse, fa.attention_delta(do, po), True, cs.BF16_TOL,
                     name, failures)
    return failures


def times(d):
    """ms of (forward, dq, dk+dv) at d's timed shape, bf16, causal."""
    q, k, v, do = cs.attention_inputs(*TIMED[d], d, torch.bfloat16, seed=1)
    o, lse = fa.flash_forward(q, k, v, True)
    delta = fa.attention_delta(do, o)
    return (cs.time_ms(lambda: fa.flash_forward(q, k, v, True)),
            cs.time_ms(lambda: fa.flash_dq(q, k, v, do, lse, delta, True)),
            cs.time_ms(lambda: fa.flash_dkv(q, k, v, do, lse, delta, True)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--work", default=None, help="directory for the copies (default: new)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    work = args.work or tempfile.mkdtemp(prefix="attention-tilings-")
    os.makedirs(work, exist_ok=True)
    names = {t: "d{}_stages{}_mt{}".format(*t) for t in TILINGS}
    with ThreadPoolExecutor(len(TILINGS)) as pool:
        libs = dict(zip(TILINGS, pool.map(
            lambda t: build_copy(work, names[t], tiling_edit(*t)), TILINGS)))
    wrong = []
    for d in TIMED:
        tilings = [t for t in TILINGS if t[0] == d]
        readings, blocks = {t: [] for t in tilings}, {}
        for i, t in enumerate(tilings + tilings[::-1]):
            build.load = lambda _name, lib=libs[t]: ctypes.CDLL(lib)
            fa._lib.cache_clear()
            if i < len(tilings):
                print("\n".join(ptxas_lines(work, names[t], d)))
                if checked(names[t], d):
                    wrong.append(names[t])
                blocks[t] = [fa.blocks_per_sm(k, d, torch.bfloat16) for k in cs.KERNELS]
            readings[t].append(times(d))
        for t, (first, second) in readings.items():
            print(f"{names[t]} at {TIMED[d] + (d,)}: ms (forward, dq, dk+dv) "
                  f"{[round(x, 4) for x in first]} then {[round(x, 4) for x in second]}; "
                  f"blocks an SM {blocks[t]}", flush=True)
    print(f"tilings whose kernels disagree with their plain versions: {wrong}")
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())

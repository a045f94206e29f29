"""The host PS apply of two trees in turns on one CUDA card.

    python3 scripts/torch_ps_apply_turns.py <parent root> <change root>

Runs each tree's own `chip_smoke.py` `phase_train` (the base transformer,
8 per-step updates in-process) and `phase_image_per_step` (cifar10 and
mnist per-step) in a fresh process, in turns: parent, change, change,
parent. Prints each run's throughput and host PS apply lines (the
ReportGradient handler's seconds a step), so a change to the PS's
report path is compared with its parent within one call.
"""

import subprocess
import sys

CODE = r"""
import os, sys, tempfile, torch
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from elasticdl_tpu_torch.ops import build
from elasticdl_tpu_torch.ops import flash_attention as fa
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build("flash_attention")
with tempfile.TemporaryDirectory() as tmp:
    cs.phase_train(fa, tmp)
    cs.phase_image_per_step(fa, tmp)
"""
parent, change = sys.argv[1:3]
for label, root in (("parent", parent), ("change", change), ("change", change),
                    ("parent", parent)):
    out = subprocess.run([sys.executable, "-c", CODE], cwd=root, capture_output=True, text=True)
    keep = [line for line in out.stdout.splitlines()
            if "PS apply" in line or "slice throughput" in line]
    print(f"== {label} rc {out.returncode}", flush=True)
    for line in keep:
        print(f"{label}: {line[:400]}", flush=True)
    if out.returncode:
        print(out.stderr[-3000:])

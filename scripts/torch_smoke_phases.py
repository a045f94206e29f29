"""Run chosen `chip_smoke.py` phases alone on one CUDA card.

    python3 scripts/torch_smoke_phases.py phase_eval_kernels,phase_resume,\
phase_async_process_job,phase_standalone_eval_predict,phase_sharded_async:0

Builds the attention kernels from the checkout, then calls each named
phase of `chip_smoke.py` in order with the arguments its signature names
(`fa`: the kernels' module, `tmp`: a temporary directory, `uds`: the
fast tiers' short socket directory, `async_job`: what
`phase_async_process_job` returned, so that one must come first; a name
followed by `:N` passes N as the phase's last argument); each phase
prints its lines and seconds.
Ends with "DEV OK" when every phase passed. For iterating on a few
phases without the whole smoke run; the smoke run is the check.
"""

import inspect
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from elasticdl_tpu_torch.ops import build  # noqa: E402
from elasticdl_tpu_torch.ops import flash_attention as fa  # noqa: E402


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    build.build("flash_attention")
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    names = sys.argv[1].split(",")
    with tempfile.TemporaryDirectory() as tmp, cs.tier_dir() as uds:
        args = {"fa": fa, "tmp": tmp, "uds": uds, "async_job": None}
        for spec in names:
            n, _, extra = spec.partition(":")
            f = getattr(cs, n)
            params = [p for p in inspect.signature(f).parameters if p in args]
            out = cs.timed(f, *[args[p] for p in params], *([int(extra)] if extra else []))
            if n == "phase_async_process_job":
                args["async_job"] = out
            print(f"{n} -> {out}", flush=True)
    print("DEV OK")


# the ImageNet phase's conversion pool spawns processes, which import
# this module again
if __name__ == "__main__":
    main()

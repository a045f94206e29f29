"""Run chosen `chip_smoke.py` phases alone on one CUDA card.

    python3 scripts/torch_smoke_phases.py phase_eval_kernels,phase_resume,\
phase_async_process_job,phase_standalone_eval_predict

Builds the attention kernels from the checkout, then calls each named
phase of `chip_smoke.py` in order with the arguments it takes (the
kernels' module, a temporary directory, the fast tiers' short socket
directory for the three phases that take it, and for
`phase_standalone_eval_predict` what `phase_async_process_job` returned,
so that one must come first); each phase prints its lines and seconds.
Ends with "DEV OK" when every phase passed. For iterating on a few
phases without the whole smoke run; the smoke run is the check.
"""

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
        async_job = None
        for n in names:
            f = getattr(cs, n)
            if n in ("phase_eval_kernels",):
                out = cs.timed(f, fa, tmp)
            elif n == "phase_standalone_eval_predict":
                out = cs.timed(f, fa, tmp, async_job)
            elif n == "phase_transport_probe":
                out = cs.timed(f, uds)
            elif n in ("phase_imagenet_async", "phase_resnet_churn"):
                out = cs.timed(f, tmp, uds)
            else:
                out = cs.timed(f, tmp)
            if n == "phase_async_process_job":
                async_job = out
            print(f"{n} -> {out}", flush=True)
    print("DEV OK")


# the ImageNet phase's conversion pool spawns processes, which import
# this module again
if __name__ == "__main__":
    main()

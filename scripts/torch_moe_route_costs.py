"""Time the pieces of the port's MoE layer on one CUDA card at the MoE
config's shape.

    python3 scripts/torch_moe_route_costs.py

The shape is one layer of `bench_transformer.py:245-257` at b8 x s1024:
T = 8,192 tokens of d = 512, E = 8 experts of d_expert 256, capacity
factor 2.0 (C = 2,048 slots an expert), bf16. Times with CUDA events
(`chip_smoke.time_ms`: the median of 5 batches of 20 calls):

- the slot positions' running count in turns (a, b, b, a): `cumsum`
  along dim 0 of the [T, E] int64 one-hot, against along the last dim
  of its [E, T] transpose (what `parallel/moe.py` does);
- `_route` (dispatch, combine, aux) and `moe_ffn_local` forward, and
  `moe_ffn_local` forward + backward;
- the four dense products alone (dispatch, the two expert products,
  combine), forward.

Then lists the ten kernels that take the most device time in one
forward + backward of `moe_ffn_local` (torch.profiler), and prints the
card's name and power limit.
"""

import math
import os
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import card_line, time_ms  # noqa: E402
from elasticdl_tpu_torch.parallel import moe  # noqa: E402

T, D, E, F_EXPERT, CAPACITY_FACTOR = 8192, 512, 8, 256, 2.0


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_moe_route_costs: no CUDA device is available", file=sys.stderr)
        return 2
    print(card_line())
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(T, D, device="cuda", generator=g).to(torch.bfloat16)
    router = (torch.randn(D, E, device="cuda", generator=g) / math.sqrt(D)).to(torch.bfloat16)
    w1 = (torch.randn(E, D, F_EXPERT, device="cuda", generator=g) / math.sqrt(D)).to(torch.bfloat16)
    w2 = (torch.randn(E, F_EXPERT, D, device="cuda", generator=g)
          / math.sqrt(F_EXPERT)).to(torch.bfloat16)
    capacity = max(1, math.ceil(T * CAPACITY_FACTOR / E))

    onehot = F.one_hot(torch.argmax((x @ router).float(), dim=-1), E)
    outer = lambda: torch.cumsum(onehot, dim=0)  # noqa: E731
    inner = lambda: torch.cumsum(onehot.t().contiguous(), dim=1).t()  # noqa: E731
    if not torch.equal(outer(), inner()):
        raise AssertionError("the two running counts differ")
    turns = {"outer": [], "inner": []}
    for name in ("outer", "inner", "inner", "outer"):
        turns[name].append(time_ms(outer if name == "outer" else inner))
    print(f"running count of the [{T}, {E}] int64 one-hot: along dim 0 "
          f"{turns['outer']} ms, along the last dim of the transpose {turns['inner']} ms")

    leaves = [t.clone().requires_grad_() for t in (x, router, w1, w2)]

    def forward_backward():
        out, aux = moe.moe_ffn_local(*leaves, capacity_factor=CAPACITY_FACTOR)
        torch.autograd.grad(out.float().sum() + aux.float(), leaves)

    dispatch, combine, _aux = moe._route(x, router, E, capacity)
    xe = (dispatch.reshape(T, E * capacity).t() @ x).reshape(E, capacity, D)
    h = torch.bmm(xe, w1)
    ye = torch.bmm(h, w2)
    times = {
        "_route": time_ms(lambda: moe._route(x, router, E, capacity)),
        "moe_ffn_local forward": time_ms(
            lambda: moe.moe_ffn_local(x, router, w1, w2, capacity_factor=CAPACITY_FACTOR)),
        "moe_ffn_local forward + backward": time_ms(forward_backward, iters=5),
        "dispatch product": time_ms(lambda: dispatch.reshape(T, E * capacity).t() @ x),
        "expert products": time_ms(lambda: torch.bmm(torch.bmm(xe, w1), w2)),
        "combine product": time_ms(
            lambda: combine.reshape(T, E * capacity) @ ye.reshape(E * capacity, D)),
    }
    print(f"one MoE layer, T {T}, d {D}, E {E}, C {capacity}, bf16: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()))

    from torch.profiler import ProfilerActivity, profile

    forward_backward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        forward_backward()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events) / 1e3
    print(f"moe_ffn_local forward + backward under the profiler: {total:.3f} ms of kernels")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:4d}x  {e.key[:300]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Measure the float32 FMA rates one CUDA card reaches in the loop shapes
of the float32 attention backward kernels.

    python3 scripts/torch_f32_fma_rates.py [--work DIR]

The float32 dq and dk+dv kernels (ops/csrc/flash_attention.cu) feed their
FMAs from rows that every lane of a warp reads from shared memory (a
broadcast). This script builds a small CUDA library (nvcc with
`ops/build.py`'s flags, into DIR, a new temporary directory by default)
and times, with CUDA events, loops of each shape on every SM of the card
(132 x 2 or 4 blocks of 128 threads):

- `ffma`: 16 independent FMA chains a thread and nothing else, the
  card's own FMA rate;
- `broadcast F`: each step reads one 16-float row of a shared tile (4
  LDS.128, one address for the whole warp) and does F FMAs with it into
  independent accumulators (F = 32: the dq walk's load to FMA ratio at
  one resident row a thread; 64: two rows);
- `broadcast F ahead`: the same with the next row read one step ahead;
- `lane F`: each lane reads its own row (conflict-free 16-byte chunks),
  for comparison.

Prints TFLOP/s (2 per FMA) beside the published 67 TFLOP/s.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from elasticdl_tpu_torch.ops import build  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>

__global__ void ffma(float* out, int n, float b, float c) {
  float a[16];
  for (int i = 0; i < 16; ++i) a[i] = threadIdx.x + i;
  for (int it = 0; it < n; ++it)
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = fmaf(a[i], b, c);
  float s = 0.f;
  for (int i = 0; i < 16; ++i) s += a[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// MODE 0: broadcast row, used at once; 1: broadcast, read a step ahead;
// 2: each lane its own row. 16 floats a row, FPL FMAs a float.
template <int MODE, int FPL>
__global__ void rows(float* out, int n) {
  __shared__ float4 sm[2048];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x) sm[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  float acc[16 * FPL], w[FPL];
  for (int i = 0; i < 16 * FPL; ++i) acc[i] = 0.f;
  for (int i = 0; i < FPL; ++i) w[i] = threadIdx.x * 1e-3f + i;
  const int lane = MODE == 2 ? (threadIdx.x & 31) * 4 : 0;
  auto load = [&](float* x, int it) {
    const int row = (it & 15) * 128 + lane;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 t = sm[row + c];
      x[4 * c] = t.x, x[4 * c + 1] = t.y, x[4 * c + 2] = t.z, x[4 * c + 3] = t.w;
    }
  };
  float x[16], nx[16];
  load(x, 0);
  for (int it = 0; it < n; ++it) {
    if (MODE == 1) load(nx, it + 1); else load(x, it);
#pragma unroll
    for (int e = 0; e < 16; ++e)
#pragma unroll
      for (int f = 0; f < FPL; ++f) acc[e * FPL + f] = fmaf(w[f], x[e], acc[e * FPL + f]);
    if (MODE == 1)
#pragma unroll
      for (int e = 0; e < 16; ++e) x[e] = nx[e];
  }
  float s = 0.f;
  for (int i = 0; i < 16 * FPL; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// ms of one launch of loop `which` (0 ffma; 1..6 rows<MODE, FPL>) on
// `blocks` blocks of 128 threads, n steps; the second of two launches
extern "C" float run(int which, int blocks, int n) {
  float* out;
  cudaMalloc(&out, (size_t)blocks * 128 * sizeof(float));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = -1.f;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    switch (which) {
      case 0: ffma<<<blocks, 128>>>(out, n, 1.0001f, 0.5f); break;
      case 1: rows<0, 2><<<blocks, 128>>>(out, n); break;
      case 2: rows<0, 4><<<blocks, 128>>>(out, n); break;
      case 3: rows<1, 2><<<blocks, 128>>>(out, n); break;
      case 4: rows<1, 4><<<blocks, 128>>>(out, n); break;
      case 5: rows<2, 2><<<blocks, 128>>>(out, n); break;
      case 6: rows<2, 4><<<blocks, 128>>>(out, n); break;
    }
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  if (cudaGetLastError() != cudaSuccess) ms = -1.f;
  cudaFree(out);
  return ms;
}
"""

# (name, which, FMAs a thread a step)
LOOPS = (
    ("ffma", 0, 16), ("broadcast 32", 1, 32), ("broadcast 64", 2, 64),
    ("broadcast 32 ahead", 3, 32), ("broadcast 64 ahead", 4, 64),
    ("lane 32", 5, 32), ("lane 64", 6, 64),
)
STEPS = 4096


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--work", default=None, help="directory for the build (default: new)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    print(cs.card_line())
    work = args.work or tempfile.mkdtemp(prefix="f32-fma-rates-")
    os.makedirs(work, exist_ok=True)
    src, lib = os.path.join(work, "fma_rates.cu"), os.path.join(work, "libfma_rates.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    run = ctypes.CDLL(lib).run
    run.argtypes, run.restype = [ctypes.c_int] * 3, ctypes.c_float
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for per_sm in (2, 4):
        for name, which, fmas in LOOPS:
            blocks = sms * per_sm
            ms = run(which, blocks, STEPS)
            if ms <= 0:
                print(f"{name}: launch failed", file=sys.stderr)
                return 1
            tflops = 2 * fmas * STEPS * blocks * 128 / ms / 1e9
            print(f"{name}, {per_sm} blocks of 128 threads an SM: {tflops:.2f} TFLOP/s "
                  f"({tflops / 67:.3f} of 67)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

// Causal (or full) flash attention for Hopper: forward, dq, and dk+dv.
//
// Replaces the reference's three Pallas TPU kernels in
// elasticdl_tpu/ops/flash_attention.py: `_fa_kernel` (forward, :79),
// `_dq_kernel` (:161) and `_dkv_kernel` (:204). Same math: scores
// s = q.k^T * scale in float32, a causal mask of -1e30 by global
// position, an online softmax (running max m, sum l, accumulator in
// float32) that writes o and lse = m + log l; the backward re-forms
// p = exp(s - lse) and ds = p * (do.v^T - delta) * scale. p is rounded
// to v's (do's) dtype before the PV (dV) product and ds to k's (q's)
// dtype before the dQ (dK) product, as the reference casts them.
//
// Layout: q, k, v, o, do, dq, dk, dv are [B, L, H, D] contiguous, D = 64
// or 128 (every kernel is a template on D), L a multiple of 64; lse and
// delta are float32 [B, H, L].
//
// Bound: at the training slices' shapes (bf16, causal: b8 x s1024 with
// 8 heads of 64, b16 x s1024 with 8 heads of 128) the forward does about
// 250 (D = 64) or 255 (D = 128) operations per byte it must move and the
// backward kernels 300-400, against the card's balance of about 295 for
// bf16 tensor cores: the forward is bound by bytes, the backward kernels
// by operations (chip_smoke.py computes and prints each bound).
//
// Every kernel: one block owns a 64-row tile of one (batch, head) (the
// D = 64 forward: 128 rows) and streams the other operand's 64-row tiles
// past it, so nothing quadratic touches device memory and no block
// writes another's output (no atomics). Causal tiles above the diagonal
// are skipped; only the diagonal tile compares positions.
//
// Two designs, chosen by dtype in the C entry points, never on failure:
//
// - bfloat16 (`fa_fwd_bf16_kernel`, `fa_dq_bf16_kernel`,
//   `fa_dkv_bf16_kernel`): the products run on the tensor cores
//   (`mma.sync.m16n8k16` bf16 x bf16 -> f32). Streamed tiles stay bf16 in
//   shared memory (64 x D: 8 KB at D = 64, 16 KB at D = 128; 16-byte
//   chunks XOR-swizzled by row so `ldmatrix` reads are free of bank
//   conflicts) and arrive by 16-byte `cp.async` into a ring of stages,
//   the next tiles' copies in flight while the current one is
//   multiplied. Each of 4 warps owns 16 q rows (dq; the forward: 32 at
//   D = 64, 16 at D = 128) or 16 k rows (dk+dv); the score accumulator of
//   m16n8 is the A-operand layout of m16n8k16, so p and ds are rounded to
//   bf16 and fed to the next product from registers, with no trip through
//   shared memory. `Tc<D>` sets what differs by head dim: at D = 128 a
//   D-wide accumulator takes 64 registers a thread, so the forward keeps
//   one row tile a warp, dq and dk+dv hold the scores of 32 k (q) columns
//   at a time instead of 64, dk+dv reads k and v from shared memory at
//   each use instead of keeping them in registers, and the ring has two
//   stages instead of three, so two blocks fit an SM.
// - float32 (all three kernels): float32 FMAs on the CUDA cores, 256
//   threads with a 4 x 4 register tile each over the 64 x 64 scores and a
//   4 x D/16 tile over D-wide outputs, float32 tiles padded to D + 4
//   floats. The tensor cores would take f32 only as TF32 (about 3 decimal
//   digits), so f32 stays on this path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int T64 = 64;       // rows per tile (q and k)
constexpr int LDS = T64 + 4;  // shared-memory row stride in floats of a 64 x 64 score tile
constexpr int NT = 256;       // threads per block: a 16 x 16 grid
constexpr float NEG_INF = -1e30f;

template <int D>
__device__ __forceinline__ size_t gidx(int b, int l, int h, int d, int L, int H) {
  return (((size_t)b * L + l) * H + h) * D + d;
}

// rows [row0, row0 + 64) of head (b, h) -> s[r * (D + 4) + d]
template <int D>
__device__ __forceinline__ void load_tile(float* s, const float* g, int b, int h, int row0,
                                          int L, int H) {
  for (int idx = threadIdx.x; idx < T64 * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    s[r * (D + 4) + d] = g[gidx<D>(b, row0 + r, h, d, L, H)];
  }
}

// acc[i][j] += sum_d A[ty*4+i][d] * B[tx+16j][d], A and B D-wide tiles
template <int D>
__device__ __forceinline__ void mm_nt(const float* A, const float* B, float acc[4][4],
                                      int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(ty * 4 + i) * LD + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(&B[(tx + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = acc[i][j];
        t = fmaf(a[i].x, b[j].x, t);
        t = fmaf(a[i].y, b[j].y, t);
        t = fmaf(a[i].z, b[j].z, t);
        t = fmaf(a[i].w, b[j].w, t);
        acc[i][j] = t;
      }
  }
}

// acc[i][j] += sum_c P[ty*4+i][c] * V[c][tx*W+j]: P a 64 x 64 score tile,
// V a D-wide tile, W = D/16 output columns a thread
template <int D>
__device__ __forceinline__ void mm_nn(const float* P, const float* V, float acc[4][D / 16],
                                      int ty, int tx) {
  constexpr int LD = D + 4, W = D / 16;
#pragma unroll 2
  for (int c = 0; c < T64; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(&P[(ty * 4 + i) * LDS + c]);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int w = 0; w < W; w += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&V[(c + cc) * LD + tx * W + w]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = cc == 0 ? p[i].x : cc == 1 ? p[i].y : cc == 2 ? p[i].z : p[i].w;
          acc[i][w] = fmaf(pv, v.x, acc[i][w]);
          acc[i][w + 1] = fmaf(pv, v.y, acc[i][w + 1]);
          acc[i][w + 2] = fmaf(pv, v.z, acc[i][w + 2]);
          acc[i][w + 3] = fmaf(pv, v.w, acc[i][w + 3]);
        }
      }
    }
  }
}

// reductions over the 16 lanes that share a row (lanes 16k .. 16k+15)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int N>
__device__ __forceinline__ void zero(float a[4][N]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) a[i][j] = 0.f;
}

// Forward; replaces `_fa_kernel` (elasticdl_tpu/ops/flash_attention.py:79).
// grid (L/64, B*H): one block per (head, 64-row q tile); k/v tiles stream
// through shared memory under the online softmax. Float32 only: bfloat16
// takes the tensor-core `fa_fwd_bf16_kernel` below.
template <int D>
__global__ void __launch_bounds__(NT) fa_fwd_kernel(const float* __restrict__ q,
                                                    const float* __restrict__ k,
                                                    const float* __restrict__ v,
                                                    float* __restrict__ o,
                                                    float* __restrict__ lse, int L, int H,
                                                    int causal, float scale) {
  constexpr int LD = D + 4, W = D / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + T64 * LD;
  float* Vs = Ks + T64 * LD;
  float* Ps = Vs + T64 * LD;  // 64 x LDS
  const int qt = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = qt * T64;

  load_tile<D>(Qs, q, b, h, q0, L, H);
  float m[4], l[4], acc[4][W];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  zero<W>(acc);

  const int n_k = causal ? qt + 1 : L / T64;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * T64;
    __syncthreads();  // the previous tile's reads of Ks/Vs/Ps are done
    load_tile<D>(Ks, k, b, h, k0, L, H);
    load_tile<D>(Vs, v, b, h, k0, L, H);
    __syncthreads();
    float s[4][4];
    zero<4>(s);
    mm_nt<D>(Qs, Ks, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (causal && q0 + ty * 4 + i < k0 + tx + 16 * j) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty * 4 + i) * LDS + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < W; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    mm_nn<D>(Ps, Vs, acc, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < W; ++j) o[gidx<D>(b, r, h, tx * W + j, L, H)] = acc[i][j] / l[i];
    if (tx == 0) lse[(size_t)bh * L + r] = m[i] + logf(l[i]);
  }
}

// dq; replaces `_dq_kernel` (elasticdl_tpu/ops/flash_attention.py:161).
// grid (L/64, B*H): one block per (head, 64-row q tile); k/v tiles stream.
// Float32 only: bfloat16 takes the tensor-core `fa_dq_bf16_kernel` below.
template <int D>
__global__ void __launch_bounds__(NT) fa_dq_kernel(const float* __restrict__ q,
                                                   const float* __restrict__ k,
                                                   const float* __restrict__ v,
                                                   const float* __restrict__ dout,
                                                   const float* __restrict__ lse,
                                                   const float* __restrict__ delta,
                                                   float* __restrict__ dq, int L, int H,
                                                   int causal, float scale) {
  constexpr int LD = D + 4, W = D / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + T64 * LD;
  float* Ks = dOs + T64 * LD;
  float* Vs = Ks + T64 * LD;
  float* DSs = Vs + T64 * LD;  // 64 x LDS
  const int qt = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = qt * T64;

  load_tile<D>(Qs, q, b, h, q0, L, H);
  load_tile<D>(dOs, dout, b, h, q0, L, H);
  float lse_r[4], delta_r[4], acc[4][W];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = lse[(size_t)bh * L + q0 + ty * 4 + i];
    delta_r[i] = delta[(size_t)bh * L + q0 + ty * 4 + i];
  }
  zero<W>(acc);

  const int n_k = causal ? qt + 1 : L / T64;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * T64;
    __syncthreads();
    load_tile<D>(Ks, k, b, h, k0, L, H);
    load_tile<D>(Vs, v, b, h, k0, L, H);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero<4>(s);
    zero<4>(dp);
    mm_nt<D>(Qs, Ks, s, ty, tx);
    mm_nt<D>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (causal && q0 + ty * 4 + i < k0 + tx + 16 * j) x = NEG_INF;
        const float p = expf(x - lse_r[i]);
        DSs[(ty * 4 + i) * LDS + tx + 16 * j] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    __syncthreads();
    mm_nn<D>(DSs, Ks, acc, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j)
      dq[gidx<D>(b, q0 + ty * 4 + i, h, tx * W + j, L, H)] = acc[i][j];
}

// dk and dv; replaces `_dkv_kernel` (elasticdl_tpu/ops/flash_attention.py:204).
// grid (L/64, B*H): one block per (head, 64-row k tile); k and v stay
// resident while q tiles stream past; no atomics. Float32 only: bfloat16
// takes the tensor-core `fa_dkv_bf16_kernel` below.
template <int D>
__global__ void __launch_bounds__(NT) fa_dkv_kernel(const float* __restrict__ q,
                                                    const float* __restrict__ k,
                                                    const float* __restrict__ v,
                                                    const float* __restrict__ dout,
                                                    const float* __restrict__ lse,
                                                    const float* __restrict__ delta,
                                                    float* __restrict__ dk,
                                                    float* __restrict__ dv, int L, int H,
                                                    int causal, float scale) {
  constexpr int LD = D + 4, W = D / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + T64 * LD;
  float* Qs = Vs + T64 * LD;
  float* dOs = Qs + T64 * LD;
  float* Ps = dOs + T64 * LD;  // 64 x LDS
  float* DSs = Ps + T64 * LDS;  // 64 x LDS
  float* lse_s = DSs + T64 * LDS;
  float* delta_s = lse_s + T64;
  const int kt = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = kt * T64;

  load_tile<D>(Ks, k, b, h, k0, L, H);
  load_tile<D>(Vs, v, b, h, k0, L, H);
  float dk_acc[4][W], dv_acc[4][W];
  zero<W>(dk_acc);
  zero<W>(dv_acc);

  for (int qt = causal ? kt : 0; qt < L / T64; ++qt) {
    const int q0 = qt * T64;
    __syncthreads();
    load_tile<D>(Qs, q, b, h, q0, L, H);
    load_tile<D>(dOs, dout, b, h, q0, L, H);
    if (threadIdx.x < T64) {
      lse_s[threadIdx.x] = lse[(size_t)bh * L + q0 + threadIdx.x];
      delta_s[threadIdx.x] = delta[(size_t)bh * L + q0 + threadIdx.x];
    }
    __syncthreads();
    // transposed tiles: row i = k row ty*4+i, column j = q row tx+16j
    float st[4][4], dpt[4][4];
    zero<4>(st);
    zero<4>(dpt);
    mm_nt<D>(Ks, Qs, st, ty, tx);
    mm_nt<D>(Vs, dOs, dpt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        float x = st[i][j] * scale;
        if (causal && q0 + r < k0 + ty * 4 + i) x = NEG_INF;
        const float p = expf(x - lse_s[r]);
        Ps[(ty * 4 + i) * LDS + r] = p;
        DSs[(ty * 4 + i) * LDS + r] = p * (dpt[i][j] - delta_s[r]) * scale;
      }
    __syncthreads();
    mm_nn<D>(Ps, dOs, dv_acc, ty, tx);
    mm_nn<D>(DSs, Qs, dk_acc, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const size_t g = gidx<D>(b, k0 + ty * 4 + i, h, tx * W + j, L, H);
      dk[g] = dk_acc[i][j];
      dv[g] = dv_acc[i][j];
    }
}

// ------------------------------------------------ bfloat16, tensor cores

using bf16 = __nv_bfloat16;

constexpr int NT_TC = 128;  // threads per block: 4 warps
constexpr float LOG2E = 1.4426950408889634f;

// The bf16 kernels' tiling by head dim (registers a thread and shared
// memory a block; PERF.md gives ptxas's counts and the blocks an SM holds)
template <int D>
struct Tc;
template <>
struct Tc<64> {
  static constexpr int STAGES = 3;  // depth of the cp.async ring of streamed tiles
  static constexpr int FWD_MT = 2;  // forward: 16-row q tiles a warp (128 q rows a block)
  static constexpr int KW = 64;     // dq, dk+dv: score columns a warp holds at once
};
template <>
struct Tc<128> {
  static constexpr int STAGES = 2;
  static constexpr int FWD_MT = 1;
  static constexpr int KW = 32;
};

// Offset of element (r, c) in a swizzled 64 x D bf16 tile: row r's
// 16-byte chunk c/8 (of D/8) sits at chunk (c/8) ^ (r%8), which changes
// only the chunk's low three bits. The 8 rows that one ldmatrix phase
// reads at one chunk column are 8 consecutive rows, so they land in 8
// distinct bank groups (a row is a whole number of 128-byte bank cycles).
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + (((c >> 3) ^ (r & 7)) << 3) + (c & 7);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(s)), "l"(g));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + 64) of head (b, h) -> swizzled tile, 16 bytes a copy
template <int D>
__device__ __forceinline__ void cp_tile(bf16* s, const bf16* g, int b, int h, int row0, int L,
                                        int H) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int it = 0; it < T64 * CH / NT_TC; ++it) {
    const int i = it * NT_TC + threadIdx.x, r = i / CH, c = (i % CH) * 8;
    cp_async16(s + swz<D>(r, c), g + gidx<D>(b, row0 + r, h, c, L, H));
  }
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(unsigned r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] . b[16x8], bf16 operands, f32 accumulator
__device__ __forceinline__ void mma(float c[4], const unsigned a[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Accumulator tiles 2j and 2j+1 (16 rows x 16 columns), rounded to bf16,
// as the A operand of the next product: the m16n8 accumulator layout is
// the m16n8k16 A layout.
__device__ __forceinline__ void acc_to_a(unsigned a[4], const float c0[4], const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// A fragments of this warp's 16 rows of a tile, all D columns
template <int D>
__device__ __forceinline__ void load_a(unsigned a[D / 16][4], const bf16* s, int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(a[kk], s + swz<D>(row0 + (lane & 15), kk * 16 + (lane >> 4) * 8));
}

// acc[mt] (16 x 16NP) += a[mt] (16 x D) . s[c0 .. c0+16NP, :]^T for MT row
// tiles of 16, s a 64 x D tile whose rows are the output's columns (B
// fragments by plain ldmatrix, each shared by the MT row tiles)
template <int D, int MT, int NP>
__device__ __forceinline__ void mm_a_bt(float (*acc)[2 * NP][4], const unsigned (*a)[D / 16][4],
                                        const bf16* s, int c0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      unsigned r[4];
      ldsm_x4(r, s + swz<D>(c0 + np * 16 + (lane & 7) + ((lane >> 4) << 3),
                            kk * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(acc[mt][2 * np], a[mt][kk], r[0], r[1]);
        mma(acc[mt][2 * np + 1], a[mt][kk], r[2], r[3]);
      }
    }
}

// As mm_a_bt for one row tile, with the A fragments of rows [arow0,
// arow0 + 16) of the tile `as` read by ldmatrix at each use instead of
// held in registers
template <int D, int NP>
__device__ __forceinline__ void mm_s_bt(float acc[2 * NP][4], const bf16* as, int arow0,
                                        const bf16* s, int c0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned a[4];
    ldsm_x4(a, as + swz<D>(arow0 + (lane & 15), kk * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      unsigned r[4];
      ldsm_x4(r, s + swz<D>(c0 + np * 16 + (lane & 7) + ((lane >> 4) << 3),
                            kk * 16 + ((lane >> 3) & 1) * 8));
      mma(acc[2 * np], a, r[0], r[1]);
      mma(acc[2 * np + 1], a, r[2], r[3]);
    }
  }
}

// acc[mt] (16 x D) += a[mt] (16 x 16) . s[k0 .. k0+16, 0 .. D] (B
// fragments by transposing ldmatrix, each shared by the MT row tiles)
template <int D, int MT>
__device__ __forceinline__ void mm_a_b(float (*acc)[D / 8][4], const unsigned (*a)[4],
                                       const bf16* s, int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    unsigned r[4];
    ldsm_x4_t(r, s + swz<D>(k0 + (lane & 7) + ((lane >> 3) & 1) * 8, np * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma(acc[mt][2 * np], a[mt], r[0], r[1]);
      mma(acc[mt][2 * np + 1], a[mt], r[2], r[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_acc(float a[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
}

// this thread's rows g, g+8 of a warp's 16 x D accumulator -> bf16 rows
// [row0, row0 + 16) of head (b, h)
template <int D>
__device__ __forceinline__ void store_rows(bf16* g, const float acc[D / 8][4], const float inv[2],
                                           int b, int h, int row0, int L, int H) {
  const int lane = threadIdx.x & 31, r = row0 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(&g[gidx<D>(b, r, h, j * 8 + c, L, H)]) =
        __floats2bfloat162_rn(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(&g[gidx<D>(b, r + 8, h, j * 8 + c, L, H)]) =
        __floats2bfloat162_rn(acc[j][2] * inv[1], acc[j][3] * inv[1]);
  }
}

// Forward, bfloat16; replaces `_fa_kernel`
// (elasticdl_tpu/ops/flash_attention.py:79). Bound by bytes at the
// slices' shapes, near the card's balance, so the design aims at the
// tensor cores' rate and at reading each k/v tile as few times as it
// can: Q is loaded once into A fragments, k/v tiles arrive by cp.async
// STAGES - 1 tiles ahead of the products, and the online softmax runs on
// the accumulator fragments (row max and sum over the 4 lanes of a row by
// two shuffles), in base 2 with log2(e) folded into the scale; lse is
// stored in natural log. Each warp owns MT row tiles of 16: at D = 64
// MT = 2, so every k/v fragment read from shared memory feeds two
// products and a block owns 128 q rows (the last is half empty when L is
// not a multiple of 128: its idle warps only help copy); at D = 128
// MT = 1 (64 q rows a block), since the 16 x 128 accumulator already
// takes 64 registers a row tile. grid (B*H, ceil(L / (64 MT))); causal
// blocks take q tiles last-first, so the longest are dispatched first.
template <int D>
__global__ void __launch_bounds__(NT_TC) fa_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int L, int H, int causal, float scale) {
  constexpr int MT = Tc<D>::FWD_MT, STAGES = Tc<D>::STAGES;
  constexpr int BM = T64 * MT, TILE = T64 * D, CH = D / 8;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* Ks = Qs + MT * TILE;       // STAGES tiles
  bf16* Vs = Ks + STAGES * TILE;  // STAGES tiles
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_qt = (L + BM - 1) / BM;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) * BM;
  const int n_k = (causal ? min(q0 + BM, L) : L) / T64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = q0 + warp * 16 * MT;  // this warp's first q row
  const bool active = w0 < L;
  const int row = lane >> 2, col = 2 * (lane & 3);  // of element 0, within a 16 x 8 tile
  const float sl2 = scale * LOG2E;

#pragma unroll
  for (int it = 0; it < BM * CH / NT_TC; ++it) {
    const int i = it * NT_TC + threadIdx.x, r = i / CH, c = (i % CH) * 8;
    if (q0 + r < L) cp_async16(Qs + swz<D>(r, c), q + gidx<D>(b, q0 + r, h, c, L, H));
  }
  // k/v tiles 0 .. STAGES-2 in flight, one commit group each (q joins the first)
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_k) {
      cp_tile<D>(Ks + t * TILE, k, b, h, t * T64, L, H);
      cp_tile<D>(Vs + t * TILE, v, b, h, t * T64, L, H);
    }
    cp_commit();
  }

  unsigned qa[MT][D / 16][4];
  float acc[MT][D / 8][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    zero_acc<D / 8>(acc[mt]);
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % STAGES, k0 = kt * T64;
    cp_wait<STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();        // ... everyone's, and the stage read at kt-1 is free
    const int nt = kt + STAGES - 1, ns = nt % STAGES;
    if (nt < n_k) {
      cp_tile<D>(Ks + ns * TILE, k, b, h, nt * T64, L, H);
      cp_tile<D>(Vs + ns * TILE, v, b, h, nt * T64, L, H);
    }
    cp_commit();  // possibly empty, so that every iteration commits one group
    if (active && kt == 0)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) load_a<D>(qa[mt], Qs, warp * 16 * MT + mt * 16);

    // a k tile wholly after this warp's last row adds nothing to it
    if (active && !(causal && k0 > w0 + 16 * MT - 1)) {
      float s[MT][8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) zero_acc<8>(s[mt]);
      mm_a_bt<D, MT, 4>(s, qa, Ks + st * TILE, 0);

      // m is the running max of the unscaled scores (the scale is
      // positive, so max(s) * scale is max(s * scale) exactly); p is one
      // FFMA and one ex2 per score
      const bool part = causal && k0 + T64 - 1 > w0;  // some (q, k) pairs are masked
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (part && w0 + mt * 16 + row + (e >> 1) * 8 < k0 + j * 8 + col + (e & 1))
              s[mt][j][e] = NEG_INF;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][j][e]);
          }
        float corr[2], ms[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          corr[i] = ex2((m[mt][i] - mx[i]) * sl2);
          m[mt][i] = mx[i];
          ms[i] = mx[i] * sl2;
          l[mt][i] *= corr[i];  // this lane's share of the row sum; lanes add up at the end
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[mt][j][e], sl2, -ms[e >> 1]));
            l[mt][e >> 1] += p;  // the unrounded p, as the reference sums it
            s[mt][j][e] = p;
            acc[mt][j][e] *= corr[e >> 1];
          }
#pragma unroll
        for (int j = 8; j < D / 8; ++j)  // the accumulator's columns past 64
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] *= corr[e >> 1];
      }
      const bf16* Vt = Vs + st * TILE;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)  // p rounded to bf16 for the PV product
          acc_to_a(pa[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
        mm_a_b<D, MT>(acc, pa, Vt, kk * 16);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[mt][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      inv[i] = 1.f / li;
      if (col == 0)
        lse[(size_t)bh * L + w0 + mt * 16 + row + 8 * i] = m[mt][i] * scale + logf(li);
    }
    store_rows<D>(o, acc[mt], inv, b, h, w0 + mt * 16, L, H);
  }
}

// dq, bfloat16; replaces `_dq_kernel`
// (elasticdl_tpu/ops/flash_attention.py:161). Bound by operations at the
// slices' shapes, three products per (q, k) pair, so the design keeps all
// three on the tensor cores: each warp loads the Q and dO fragments of
// its 16 q rows into registers once (with its rows' lse, in base 2, and
// delta), k/v tiles arrive through the cp.async ring, and per tile the
// warp forms s = q.k^T and dp = do.v^T over KW k columns at a time (all
// 64 at D = 64; 32 at D = 128, where Q, dO and the dQ accumulator already
// hold 128 registers), then p = exp(s scale - lse) and ds = p (dp -
// delta) scale on the accumulator fragments, and feeds ds, rounded to
// bf16, from registers into dQ += ds.k (k by transposing ldmatrix from
// the same stage), so no shared-memory round trip or extra __syncthreads
// sits between the products. k columns wholly after a warp's last row
// are skipped. 4 warps, 64 q rows a block, grid (B*H, L/64); causal
// blocks take q tiles last-first, so the longest are dispatched first.
// Two blocks an SM: at D = 64 ptxas spills at a minimum of three blocks
// (168 registers) and, oddly, with no minimum given.
template <int D>
__global__ void __launch_bounds__(NT_TC, 2) fa_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int L, int H, int causal,
    float scale) {
  constexpr int STAGES = Tc<D>::STAGES, KW = Tc<D>::KW, TILE = T64 * D;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* dOs = Qs + TILE;
  bf16* Ks = dOs + TILE;          // STAGES tiles
  bf16* Vs = Ks + STAGES * TILE;  // STAGES tiles
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_qt = L / T64;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) * T64;
  const int n_k = (causal ? q0 + T64 : L) / T64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = q0 + warp * 16;  // this warp's first q row
  const int row = lane >> 2, col = 2 * (lane & 3);  // of element 0, within a 16 x 8 tile
  const float sl2 = scale * LOG2E;

  cp_tile<D>(Qs, q, b, h, q0, L, H);
  cp_tile<D>(dOs, dout, b, h, q0, L, H);
  // k/v tiles 0 .. STAGES-2 in flight, one commit group each (q and do
  // join the first)
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_k) {
      cp_tile<D>(Ks + t * TILE, k, b, h, t * T64, L, H);
      cp_tile<D>(Vs + t * TILE, v, b, h, t * T64, L, H);
    }
    cp_commit();
  }

  // lse (base 2) and delta of this thread's rows w0 + row, w0 + row + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = lse[(size_t)bh * L + w0 + row + 8 * i] * LOG2E;
    dl[i] = delta[(size_t)bh * L + w0 + row + 8 * i];
  }
  unsigned qa[D / 16][4], doa[D / 16][4];
  float acc[D / 8][4];
  zero_acc<D / 8>(acc);

  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % STAGES, k0 = kt * T64;
    cp_wait<STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();        // ... everyone's, and the stage read at kt-1 is free
    const int nt = kt + STAGES - 1, ns = nt % STAGES;
    if (nt < n_k) {
      cp_tile<D>(Ks + ns * TILE, k, b, h, nt * T64, L, H);
      cp_tile<D>(Vs + ns * TILE, v, b, h, nt * T64, L, H);
    }
    cp_commit();  // possibly empty, so that every iteration commits one group
    if (kt == 0) {
      load_a<D>(qa, Qs, warp * 16);
      load_a<D>(doa, dOs, warp * 16);
    }
    const bf16* Kt = Ks + st * TILE;
    const bf16* Vt = Vs + st * TILE;

#pragma unroll
    for (int c0 = 0; c0 < T64; c0 += KW) {
      const int kc = k0 + c0;  // the first k column of this pass
      // k columns wholly after this warp's last row add nothing to it
      if (causal && kc > w0 + 15) continue;
      float s[KW / 8][4], dp[KW / 8][4];  // s then ds; dp
      zero_acc<KW / 8>(s);
      zero_acc<KW / 8>(dp);
      mm_a_bt<D, 1, KW / 16>(&s, &qa, Kt, c0);
      mm_a_bt<D, 1, KW / 16>(&dp, &doa, Vt, c0);

      const bool part = causal && kc + KW - 1 > w0;  // some (q, k) pairs are masked
#pragma unroll
      for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[j][e], sl2, -lse2[e >> 1]));
          if (part && w0 + row + (e >> 1) * 8 < kc + j * 8 + col + (e & 1)) p = 0.f;  // q before k
          s[j][e] = p * (dp[j][e] - dl[e >> 1]) * scale;
        }
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        unsigned a[1][4];
        acc_to_a(a[0], s[2 * kk], s[2 * kk + 1]);  // ds rounded to bf16
        mm_a_b<D, 1>(&acc, a, Kt, c0 + kk * 16);
      }
    }
  }

  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq, acc, one, b, h, w0, L, H);
}

// dk and dv, bfloat16; replaces `_dkv_kernel`
// (elasticdl_tpu/ops/flash_attention.py:204). Bound by operations at the
// slices' shapes, four products per (q, k) pair, so the design keeps all
// four on the tensor cores: each warp owns 16 k rows; q/do tiles and
// their lse/delta rows stream through the cp.async ring, and per tile the
// warp forms the transposed tiles s^T = k.q^T and dp^T = v.do^T over KW q
// columns at a time, then p^T = exp(s^T scale - lse) and ds^T = p^T
// (dp^T - delta) scale, and feeds both, rounded to bf16, from registers
// into dV += p^T.do and dK += ds^T.q. At D = 64 k and v sit in registers
// as A fragments; at D = 128, where the dK and dV accumulators take 128
// registers, they are read from shared memory by ldmatrix at each use and
// the scores come 32 q columns at a time. grid (B*H, L/64), k tiles in
// ascending order: the causal blocks with the most q tiles are dispatched
// first.
template <int D>
__global__ void __launch_bounds__(NT_TC) fa_dkv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int H,
    int causal, float scale) {
  constexpr int STAGES = Tc<D>::STAGES, KW = Tc<D>::KW, TILE = T64 * D;
  constexpr bool KV_REGS = D == 64;  // k and v as register A fragments
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;            // STAGES tiles
  bf16* dOs = Qs + STAGES * TILE;  // STAGES tiles
  float* rows = reinterpret_cast<float*>(dOs + STAGES * TILE);  // STAGES x (lse[64], delta[64])
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kt = blockIdx.y, k0 = kt * T64, n_q = L / T64, q_first = causal ? kt : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 2), col = 2 * (lane & 3);
  const float sl2 = scale * LOG2E;

  auto load_stage = [&](int st, int qt) {
    cp_tile<D>(Qs + st * TILE, q, b, h, qt * T64, L, H);
    cp_tile<D>(dOs + st * TILE, dout, b, h, qt * T64, L, H);
    if (threadIdx.x < 32) {  // 16 copies each for lse and delta
      const int i = threadIdx.x & 15;
      const float* src = threadIdx.x < 16 ? lse : delta;
      cp_async16(rows + st * 2 * T64 + (threadIdx.x >> 4) * T64 + 4 * i,
                 src + (size_t)bh * L + qt * T64 + 4 * i);
    }
  };

  // q tiles q_first .. q_first+STAGES-2 in flight, one commit group each
  // (k and v join the first)
  cp_tile<D>(Ks, k, b, h, k0, L, H);
  cp_tile<D>(Vs, v, b, h, k0, L, H);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (q_first + t < n_q) load_stage(t, q_first + t);
    cp_commit();
  }

  unsigned ka[KV_REGS ? D / 16 : 1][4], va[KV_REGS ? D / 16 : 1][4];
  float dka[D / 8][4], dva[D / 8][4];
  zero_acc<D / 8>(dka);
  zero_acc<D / 8>(dva);

  for (int qt = q_first; qt < n_q; ++qt) {
    const int st = (qt - q_first) % STAGES;
    cp_wait<STAGES - 2>();  // tile qt has landed (this thread's copies)
    __syncthreads();        // ... everyone's, and the stage read at qt-1 is free
    const int nt = qt + STAGES - 1;
    if (nt < n_q) load_stage((nt - q_first) % STAGES, nt);
    cp_commit();  // possibly empty, so that every iteration commits one group
    if constexpr (KV_REGS) {
      if (qt == q_first) {
        load_a<D>(ka, Ks, warp * 16);
        load_a<D>(va, Vs, warp * 16);
      }
    }
    const bf16* Qt = Qs + st * TILE;
    const bf16* dOt = dOs + st * TILE;
    const float* lse_s = rows + st * 2 * T64;
    const float* delta_s = lse_s + T64;
    const bool diag = causal && qt == kt;

#pragma unroll
    for (int c0 = 0; c0 < T64; c0 += KW) {
      // every q of this pass before every k row of this warp
      if (diag && c0 + KW - 1 < warp * 16) continue;
      float pt[KW / 8][4], dst[KW / 8][4];  // s^T then p^T; dp^T then ds^T
      zero_acc<KW / 8>(pt);
      zero_acc<KW / 8>(dst);
      if constexpr (KV_REGS) {
        mm_a_bt<D, 1, KW / 16>(&pt, &ka, Qt, c0);
        mm_a_bt<D, 1, KW / 16>(&dst, &va, dOt, c0);
      } else {
        mm_s_bt<D, KW / 16>(pt, Ks, warp * 16, Qt, c0);
        mm_s_bt<D, KW / 16>(dst, Vs, warp * 16, dOt, c0);
      }

#pragma unroll
      for (int j = 0; j < KW / 8; ++j) {
        const int qc = c0 + j * 8 + col;  // this thread's q column within the tile
        const float2 ls = *reinterpret_cast<const float2*>(&lse_s[qc]);
        const float2 dl = *reinterpret_cast<const float2*>(&delta_s[qc]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lq = (e & 1) ? ls.y : ls.x, dq = (e & 1) ? dl.y : dl.x;
          float p = ex2(fmaf(pt[j][e], sl2, -lq * LOG2E));
          if (diag && qc + (e & 1) < row + (e >> 1) * 8) p = 0.f;  // q before k
          pt[j][e] = p;
          dst[j][e] = p * (dst[j][e] - dq) * scale;
        }
      }
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        unsigned a[1][4];
        acc_to_a(a[0], pt[2 * kk], pt[2 * kk + 1]);  // p^T rounded to bf16
        mm_a_b<D, 1>(&dva, a, dOt, c0 + kk * 16);
        acc_to_a(a[0], dst[2 * kk], dst[2 * kk + 1]);  // ds^T rounded to bf16
        mm_a_b<D, 1>(&dka, a, Qt, c0 + kk * 16);
      }
    }
  }

  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk, dka, one, b, h, k0 + warp * 16, L, H);
  store_rows<D>(dv, dva, one, b, h, k0 + warp * 16, L, H);
}

bool bad_shape(int B, int L, int H, int Dh) {
  return (Dh != 64 && Dh != 128) || L <= 0 || L % T64 != 0 || B <= 0 || H <= 0 ||
         (long)B * H > 65535;
}

// Dynamic shared memory of each kernel at head dim D (bytes)
template <int D>
size_t smem_f32(int tiles, int score_tiles, int rows) {
  return sizeof(float) * ((size_t)tiles * T64 * (D + 4) + (size_t)score_tiles * T64 * LDS +
                          (size_t)rows * T64);
}
template <int D>
size_t smem_fwd_bf16() {  // q rows and the k/v stages (D = 64: 64 KB, D = 128: 80 KB)
  return (Tc<D>::FWD_MT + 2 * Tc<D>::STAGES) * T64 * D * sizeof(bf16);
}
template <int D>
size_t smem_dq_bf16() {  // q and do tiles and the k/v stages (64 KB, 96 KB)
  return (2 + 2 * Tc<D>::STAGES) * T64 * D * sizeof(bf16);
}
template <int D>
size_t smem_dkv_bf16() {  // k and v tiles, the q/do stages and their lse/delta rows (65.5 KB, 97 KB)
  return (2 + 2 * Tc<D>::STAGES) * T64 * D * sizeof(bf16) + Tc<D>::STAGES * 2 * T64 * sizeof(float);
}

// Each kernel's launch by head dim and dtype (which: 0 forward, 1 dq, 2
// dk+dv): its function, grid, threads and dynamic shared memory. The
// launches and the occupancy query both read it. The float32 kernels run
// one block per 64 rows of a head, grid (L/64, B*H); the bfloat16 ones
// take the head first, grid (B*H, q or k tiles).
struct Launch {
  const void* fn;
  dim3 grid;
  int threads;
  size_t smem;
};

template <int D>
Launch launch_of(int which, int dtype, int B, int L, int H) {
  const dim3 rows(L / T64, B * H), heads(B * H, L / T64);
  if (dtype == 0) {
    if (which == 0) return {(const void*)fa_fwd_kernel<D>, rows, NT, smem_f32<D>(3, 1, 0)};
    if (which == 1) return {(const void*)fa_dq_kernel<D>, rows, NT, smem_f32<D>(4, 1, 0)};
    return {(const void*)fa_dkv_kernel<D>, rows, NT, smem_f32<D>(4, 2, 2)};
  }
  if (which == 0) {
    const int bm = T64 * Tc<D>::FWD_MT;
    return {(const void*)fa_fwd_bf16_kernel<D>, dim3(B * H, (L + bm - 1) / bm), NT_TC,
            smem_fwd_bf16<D>()};
  }
  if (which == 1) return {(const void*)fa_dq_bf16_kernel<D>, heads, NT_TC, smem_dq_bf16<D>()};
  return {(const void*)fa_dkv_bf16_kernel<D>, heads, NT_TC, smem_dkv_bf16<D>()};
}

Launch launch_of(int which, int Dh, int dtype, int B, int L, int H) {
  return Dh == 64 ? launch_of<64>(which, dtype, B, L, H) : launch_of<128>(which, dtype, B, L, H);
}

// cudaFuncSetAttribute for the dynamic shared memory, then the launch of
// kernel `which` with the kernel's arguments `args`; returns the
// cudaError_t
int launch(int which, int B, int L, int H, int Dh, int dtype, void** args, void* stream) {
  if (bad_shape(B, L, H, Dh) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const Launch k = launch_of(which, Dh, dtype, B, L, H);
  cudaError_t e = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)k.smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaLaunchKernel(k.fn, k.grid, dim3(k.threads), args, k.smem,
                               static_cast<cudaStream_t>(stream));
}

}  // namespace

// C entry points. dtype: 0 = float32, 1 = bfloat16; the dtype picks the
// design (the CUDA-core kernel for float32, the tensor-core kernel for
// bfloat16) and Dh (64 or 128) its instantiation. Each returns the
// cudaError_t of the launch (0 on success); the kernel runs on `stream`.
// The pointers are passed on as the kernel's float or bf16 pointers.
extern "C" {

int edl_fa_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int L,
               int H, int Dh, int causal, float scale, int dtype, void* stream) {
  void* args[] = {&q, &k, &v, &o, &lse, &L, &H, &causal, &scale};
  return launch(0, B, L, H, Dh, dtype, args, stream);
}

int edl_fa_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int L, int H, int Dh, int causal, float scale,
              int dtype, void* stream) {
  void* args[] = {&q, &k, &v, &dout, &lse, &delta, &dq, &L, &H, &causal, &scale};
  return launch(1, B, L, H, Dh, dtype, args, stream);
}

int edl_fa_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int L, int H, int Dh, int causal,
               float scale, int dtype, void* stream) {
  void* args[] = {&q, &k, &v, &dout, &lse, &delta, &dk, &dv, &L, &H, &causal, &scale};
  return launch(2, B, L, H, Dh, dtype, args, stream);
}

// Blocks an SM holds of kernel `which` (0 forward, 1 dq, 2 dk+dv) at
// head dim Dh and dtype, by the occupancy calculator (registers, shared
// memory and threads together); a negative value is a cudaError_t
int edl_fa_blocks_per_sm(int which, int Dh, int dtype) {
  if (bad_shape(1, T64, 1, Dh) || (dtype != 0 && dtype != 1)) return -(int)cudaErrorInvalidValue;
  const Launch k = launch_of(which, Dh, dtype, 1, T64, 1);
  cudaError_t e = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)k.smem);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k.fn, k.threads,
                                                                          k.smem);
  return e == cudaSuccess ? n : -(int)e;
}

}  // extern "C"

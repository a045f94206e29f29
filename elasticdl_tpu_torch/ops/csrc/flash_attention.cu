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
// Layout: q, k, v, o, do, dq, dk, dv are [B, L, H, D] contiguous, D = 64,
// L a multiple of 64; lse and delta are float32 [B, H, L].
//
// Bound: at the training slice's shapes (b8 x s1024, 8 heads of 64,
// bf16, causal) the forward does about 250 operations per byte it must
// move and the backward kernels about 300-340, against the card's
// balance of about 295 for bf16 tensor cores: the least time is
// ~0.010 ms (bytes) for the forward and ~0.013 / ~0.017 ms (operations)
// for dq / dk+dv (chip_smoke.py computes and prints them).
//
// Every kernel: one block owns a 64-row tile of one (batch, head) and
// streams the other operand's 64-row tiles past it, so nothing quadratic
// touches device memory and no block writes another's output (no
// atomics). Causal tiles above the diagonal are skipped; only the
// diagonal tile compares positions.
//
// Two designs, chosen by dtype in the C entry points, never on failure:
//
// - bfloat16 (`fa_fwd_bf16_kernel`, `fa_dq_bf16_kernel`,
//   `fa_dkv_bf16_kernel`): the products run on the tensor cores
//   (`mma.sync.m16n8k16` bf16 x bf16 -> f32). Streamed tiles stay bf16 in
//   shared memory (8 KB per 64 x 64 tile, 16-byte chunks XOR-swizzled by
//   row so `ldmatrix` reads are free of bank conflicts) and arrive by
//   16-byte `cp.async` into a three-stage ring, the next tiles' copies in
//   flight while the current one is multiplied. Each of 4 warps owns 32
//   q rows (forward), 16 q rows (dq) or 16 k rows (dk+dv); the score
//   accumulator of m16n8 is the A-operand layout of m16n8k16, so p and ds
//   are rounded to bf16 and fed to the next product from registers, with
//   no trip through shared memory.
// - float32 (all three kernels): float32 FMAs on the CUDA cores, 256
//   threads with a 4x4 register tile each over float32 tiles padded to 68
//   floats. The tensor cores would take f32 only as TF32 (about 3 decimal
//   digits), so f32 stays on this path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int D = 64;            // head dim
constexpr int T64 = 64;          // rows per tile (q and k alike)
constexpr int LD = D + 4;        // shared-memory row stride in floats
constexpr int NT = 256;          // threads per block: a 16 x 16 grid
constexpr float NEG_INF = -1e30f;
constexpr size_t TILE_BYTES = sizeof(float) * T64 * LD;

__device__ __forceinline__ size_t gidx(int b, int l, int h, int d, int L, int H) {
  return (((size_t)b * L + l) * H + h) * D + d;
}

// rows [row0, row0 + 64) of head (b, h) -> s[r * LD + d]
__device__ __forceinline__ void load_tile(float* s, const float* g, int b, int h, int row0,
                                          int L, int H) {
  for (int idx = threadIdx.x; idx < T64 * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    s[r * LD + d] = g[gidx(b, row0 + r, h, d, L, H)];
  }
}

// acc[i][j] += sum_d A[ty*4+i][d] * B[tx+16j][d]
__device__ __forceinline__ void mm_nt(const float* A, const float* B, float acc[4][4],
                                      int ty, int tx) {
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

// acc[i][j] += sum_c P[ty*4+i][c] * V[c][tx*4+j]
__device__ __forceinline__ void mm_nn(const float* P, const float* V, float acc[4][4],
                                      int ty, int tx) {
#pragma unroll 2
  for (int c = 0; c < T64; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(&P[(ty * 4 + i) * LD + c]);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float4 v = *reinterpret_cast<const float4*>(&V[(c + cc) * LD + tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = cc == 0 ? p[i].x : cc == 1 ? p[i].y : cc == 2 ? p[i].z : p[i].w;
        acc[i][0] = fmaf(pv, v.x, acc[i][0]);
        acc[i][1] = fmaf(pv, v.y, acc[i][1]);
        acc[i][2] = fmaf(pv, v.z, acc[i][2]);
        acc[i][3] = fmaf(pv, v.w, acc[i][3]);
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

__device__ __forceinline__ void zero(float a[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

// Forward; replaces `_fa_kernel` (elasticdl_tpu/ops/flash_attention.py:79).
// grid (L/64, B*H): one block per (head, 64-row q tile); k/v tiles stream
// through shared memory under the online softmax. Bound at the slice's
// shapes: bytes (~0.010 ms). Float32 only: bfloat16 takes the
// tensor-core `fa_fwd_bf16_kernel` below.
__global__ void __launch_bounds__(NT) fa_fwd_kernel(const float* __restrict__ q,
                                                    const float* __restrict__ k,
                                                    const float* __restrict__ v,
                                                    float* __restrict__ o,
                                                    float* __restrict__ lse, int L, int H,
                                                    int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + T64 * LD;
  float* Vs = Ks + T64 * LD;
  float* Ps = Vs + T64 * LD;
  const int qt = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = qt * T64;

  load_tile(Qs, q, b, h, q0, L, H);
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  zero(acc);

  const int n_k = causal ? qt + 1 : L / T64;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * T64;
    __syncthreads();  // the previous tile's reads of Ks/Vs/Ps are done
    load_tile(Ks, k, b, h, k0, L, H);
    load_tile(Vs, v, b, h, k0, L, H);
    __syncthreads();
    float s[4][4];
    zero(s);
    mm_nt(Qs, Ks, s, ty, tx);
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
        Ps[(ty * 4 + i) * LD + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    mm_nn(Ps, Vs, acc, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[gidx(b, r, h, tx * 4 + j, L, H)] = acc[i][j] / l[i];
    if (tx == 0) lse[(size_t)bh * L + r] = m[i] + logf(l[i]);
  }
}

// dq; replaces `_dq_kernel` (elasticdl_tpu/ops/flash_attention.py:161).
// grid (L/64, B*H): one block per (head, 64-row q tile); k/v tiles stream.
// Bound at the slice's shapes: operations (~0.013 ms). Float32 only:
// bfloat16 takes the tensor-core `fa_dq_bf16_kernel` below.
__global__ void __launch_bounds__(NT) fa_dq_kernel(const float* __restrict__ q,
                                                   const float* __restrict__ k,
                                                   const float* __restrict__ v,
                                                   const float* __restrict__ dout,
                                                   const float* __restrict__ lse,
                                                   const float* __restrict__ delta,
                                                   float* __restrict__ dq, int L, int H,
                                                   int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + T64 * LD;
  float* Ks = dOs + T64 * LD;
  float* Vs = Ks + T64 * LD;
  float* DSs = Vs + T64 * LD;
  const int qt = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = qt * T64;

  load_tile(Qs, q, b, h, q0, L, H);
  load_tile(dOs, dout, b, h, q0, L, H);
  float lse_r[4], delta_r[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = lse[(size_t)bh * L + q0 + ty * 4 + i];
    delta_r[i] = delta[(size_t)bh * L + q0 + ty * 4 + i];
  }
  zero(acc);

  const int n_k = causal ? qt + 1 : L / T64;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * T64;
    __syncthreads();
    load_tile(Ks, k, b, h, k0, L, H);
    load_tile(Vs, v, b, h, k0, L, H);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mm_nt(Qs, Ks, s, ty, tx);
    mm_nt(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (causal && q0 + ty * 4 + i < k0 + tx + 16 * j) x = NEG_INF;
        const float p = expf(x - lse_r[i]);
        DSs[(ty * 4 + i) * LD + tx + 16 * j] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    __syncthreads();
    mm_nn(DSs, Ks, acc, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dq[gidx(b, q0 + ty * 4 + i, h, tx * 4 + j, L, H)] = acc[i][j];
}

// dk and dv; replaces `_dkv_kernel` (elasticdl_tpu/ops/flash_attention.py:204).
// grid (L/64, B*H): one block per (head, 64-row k tile); k and v stay
// resident while q tiles stream past; no atomics. Bound at the slice's
// shapes: operations (~0.017 ms). Float32 only: bfloat16 takes the
// tensor-core `fa_dkv_bf16_kernel` below.
__global__ void __launch_bounds__(NT) fa_dkv_kernel(const float* __restrict__ q,
                                                    const float* __restrict__ k,
                                                    const float* __restrict__ v,
                                                    const float* __restrict__ dout,
                                                    const float* __restrict__ lse,
                                                    const float* __restrict__ delta,
                                                    float* __restrict__ dk,
                                                    float* __restrict__ dv, int L, int H,
                                                    int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + T64 * LD;
  float* Qs = Vs + T64 * LD;
  float* dOs = Qs + T64 * LD;
  float* Ps = dOs + T64 * LD;
  float* DSs = Ps + T64 * LD;
  float* lse_s = DSs + T64 * LD;
  float* delta_s = lse_s + T64;
  const int kt = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = kt * T64;

  load_tile(Ks, k, b, h, k0, L, H);
  load_tile(Vs, v, b, h, k0, L, H);
  float dk_acc[4][4], dv_acc[4][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int qt = causal ? kt : 0; qt < L / T64; ++qt) {
    const int q0 = qt * T64;
    __syncthreads();
    load_tile(Qs, q, b, h, q0, L, H);
    load_tile(dOs, dout, b, h, q0, L, H);
    if (threadIdx.x < T64) {
      lse_s[threadIdx.x] = lse[(size_t)bh * L + q0 + threadIdx.x];
      delta_s[threadIdx.x] = delta[(size_t)bh * L + q0 + threadIdx.x];
    }
    __syncthreads();
    // transposed tiles: row i = k row ty*4+i, column j = q row tx+16j
    float st[4][4], dpt[4][4];
    zero(st);
    zero(dpt);
    mm_nt(Ks, Qs, st, ty, tx);
    mm_nt(Vs, dOs, dpt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        float x = st[i][j] * scale;
        if (causal && q0 + r < k0 + ty * 4 + i) x = NEG_INF;
        const float p = expf(x - lse_s[r]);
        Ps[(ty * 4 + i) * LD + r] = p;
        DSs[(ty * 4 + i) * LD + r] = p * (dpt[i][j] - delta_s[r]) * scale;
      }
    __syncthreads();
    mm_nn(Ps, dOs, dv_acc, ty, tx);
    mm_nn(DSs, Qs, dk_acc, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t g = gidx(b, k0 + ty * 4 + i, h, tx * 4 + j, L, H);
      dk[g] = dk_acc[i][j];
      dv[g] = dv_acc[i][j];
    }
}

// ------------------------------------------------ bfloat16, tensor cores

using bf16 = __nv_bfloat16;

constexpr int NT_TC = 128;     // threads per block: 4 warps
constexpr int TILE = T64 * D;  // elements of a 64 x 64 bf16 tile (8 KB)
constexpr int STAGES = 3;      // depth of the cp.async ring of streamed tiles
constexpr int FWD_MT = 2;      // 16-row tiles per warp in the forward (128 q rows a block)
constexpr float LOG2E = 1.4426950408889634f;

// Offset of element (r, c) in a swizzled 64 x 64 bf16 tile: row r's
// 16-byte chunk c/8 sits at chunk (c/8) ^ (r%8), so the 8 rows that one
// ldmatrix phase reads at one chunk column land in 8 distinct bank groups.
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
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
__device__ __forceinline__ void cp_tile(bf16* s, const bf16* g, int b, int h, int row0, int L,
                                        int H) {
#pragma unroll
  for (int it = 0; it < T64 * 8 / NT_TC; ++it) {
    const int i = it * NT_TC + threadIdx.x, r = i >> 3, c = (i & 7) << 3;
    cp_async16(s + swz(r, c), g + gidx(b, row0 + r, h, c, L, H));
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

// A fragments of this warp's 16 rows of a tile, all 64 columns
__device__ __forceinline__ void load_a(unsigned a[4][4], const bf16* s, int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(a[kk], s + swz(row0 + (lane & 15), kk * 16 + (lane >> 4) * 8));
}

// acc[mt] (16 x 64) += a[mt] (16 x 64) . s^T for MT row tiles of 16, s a
// 64 x 64 tile whose rows are the output's columns (B fragments by plain
// ldmatrix, each shared by the MT row tiles)
template <int MT>
__device__ __forceinline__ void mm_a_bt(float (*acc)[8][4], const unsigned (*a)[4][4],
                                        const bf16* s) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned r[4];
      ldsm_x4(r, s + swz(np * 16 + (lane & 7) + ((lane >> 4) << 3), kk * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(acc[mt][2 * np], a[mt][kk], r[0], r[1]);
        mma(acc[mt][2 * np + 1], a[mt][kk], r[2], r[3]);
      }
    }
}

// acc[mt] (16 x 64) += a[mt] (16 x 16) . s[k0 .. k0+16, 0 .. 64] (B
// fragments by transposing ldmatrix, each shared by the MT row tiles)
template <int MT>
__device__ __forceinline__ void mm_a_b(float (*acc)[8][4], const unsigned (*a)[4], const bf16* s,
                                       int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    unsigned r[4];
    ldsm_x4_t(r, s + swz(k0 + (lane & 7) + ((lane >> 3) & 1) * 8, np * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma(acc[mt][2 * np], a[mt], r[0], r[1]);
      mma(acc[mt][2 * np + 1], a[mt], r[2], r[3]);
    }
  }
}

__device__ __forceinline__ void zero8(float a[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
}

// this thread's rows g, g+8 of a warp's 16 x 64 accumulator -> bf16 rows
// [row0, row0 + 16) of head (b, h)
__device__ __forceinline__ void store_rows(bf16* g, const float acc[8][4], const float inv[2],
                                           int b, int h, int row0, int L, int H) {
  const int lane = threadIdx.x & 31, r = row0 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(&g[gidx(b, r, h, j * 8 + c, L, H)]) =
        __floats2bfloat162_rn(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(&g[gidx(b, r + 8, h, j * 8 + c, L, H)]) =
        __floats2bfloat162_rn(acc[j][2] * inv[1], acc[j][3] * inv[1]);
  }
}

// Forward, bfloat16; replaces `_fa_kernel`
// (elasticdl_tpu/ops/flash_attention.py:79). Bound at the slice's shapes:
// bytes (~0.010 ms), at ~250 operations per byte, near the card's
// balance, so the design aims at the tensor cores' rate and at reading
// each k/v tile as few times as it can: Q is loaded once into A
// fragments, k/v tiles arrive by cp.async two tiles ahead of the
// products, and the online softmax runs on the accumulator fragments
// (row max and sum over the 4 lanes of a row by two shuffles), in base 2
// with log2(e) folded into the scale; lse is stored in natural log. Each
// warp owns MT = 2 row tiles of 16, so every k/v fragment read from
// shared memory feeds two products, and a block owns 128 q rows (the
// last is half empty when L is not a multiple of 128: its idle warps only
// help copy). grid (B*H, ceil(L / 128)); causal blocks take q tiles
// last-first, so the longest are dispatched first.
__global__ void __launch_bounds__(NT_TC) fa_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int L, int H, int causal, float scale) {
  constexpr int MT = FWD_MT, BM = T64 * MT;  // q rows of the block
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
  for (int it = 0; it < BM * 8 / NT_TC; ++it) {
    const int i = it * NT_TC + threadIdx.x, r = i >> 3, c = (i & 7) << 3;
    if (q0 + r < L) cp_async16(Qs + swz(r, c), q + gidx(b, q0 + r, h, c, L, H));
  }
  // k/v tiles 0 .. STAGES-2 in flight, one commit group each (q joins the first)
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_k) {
      cp_tile(Ks + t * TILE, k, b, h, t * T64, L, H);
      cp_tile(Vs + t * TILE, v, b, h, t * T64, L, H);
    }
    cp_commit();
  }

  unsigned qa[MT][4][4];
  float acc[MT][8][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    zero8(acc[mt]);
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % STAGES, k0 = kt * T64;
    cp_wait<STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();        // ... everyone's, and the stage read at kt-1 is free
    const int nt = kt + STAGES - 1, ns = nt % STAGES;
    if (nt < n_k) {
      cp_tile(Ks + ns * TILE, k, b, h, nt * T64, L, H);
      cp_tile(Vs + ns * TILE, v, b, h, nt * T64, L, H);
    }
    cp_commit();  // possibly empty, so that every iteration commits one group
    if (active && kt == 0)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) load_a(qa[mt], Qs, warp * 16 * MT + mt * 16);

    // a k tile wholly after this warp's last row adds nothing to it
    if (active && !(causal && k0 > w0 + 16 * MT - 1)) {
      float s[MT][8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) zero8(s[mt]);
      mm_a_bt<MT>(s, qa, Ks + st * TILE);

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
      }
      const bf16* Vt = Vs + st * TILE;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)  // p rounded to bf16 for the PV product
          acc_to_a(pa[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
        mm_a_b<MT>(acc, pa, Vt, kk * 16);
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
    store_rows(o, acc[mt], inv, b, h, w0 + mt * 16, L, H);
  }
}

// dq, bfloat16; replaces `_dq_kernel`
// (elasticdl_tpu/ops/flash_attention.py:161). Bound at the slice's
// shapes: operations (~0.013 ms), three products per (q, k) pair, so the
// design keeps all three on the tensor cores: each warp loads the Q and
// dO fragments of its 16 q rows into registers once (with its rows' lse,
// in base 2, and delta), k/v tiles arrive through the three-stage
// cp.async ring, and per tile the warp forms s = q.k^T and dp = do.v^T,
// then p = exp(s scale - lse) and ds = p (dp - delta) scale on the
// accumulator fragments, and feeds ds, rounded to bf16, from registers
// into dQ += ds.k (k by transposing ldmatrix from the same stage), so no
// shared-memory round trip or extra __syncthreads sits between the
// products. A k tile wholly after a warp's last row is skipped. 4 warps,
// 64 q rows a block, grid (B*H, L/64); causal blocks take q tiles
// last-first, so the longest are dispatched first. Two blocks an SM
// (198 registers): ptxas spills at a minimum of three blocks (168
// registers) and, oddly, with no minimum given.
__global__ void __launch_bounds__(NT_TC, 2) fa_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int L, int H, int causal,
    float scale) {
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

  cp_tile(Qs, q, b, h, q0, L, H);
  cp_tile(dOs, dout, b, h, q0, L, H);
  // k/v tiles 0 .. STAGES-2 in flight, one commit group each (q and do
  // join the first)
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_k) {
      cp_tile(Ks + t * TILE, k, b, h, t * T64, L, H);
      cp_tile(Vs + t * TILE, v, b, h, t * T64, L, H);
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
  unsigned qa[4][4], doa[4][4];
  float acc[8][4];
  zero8(acc);

  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % STAGES, k0 = kt * T64;
    cp_wait<STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();        // ... everyone's, and the stage read at kt-1 is free
    const int nt = kt + STAGES - 1, ns = nt % STAGES;
    if (nt < n_k) {
      cp_tile(Ks + ns * TILE, k, b, h, nt * T64, L, H);
      cp_tile(Vs + ns * TILE, v, b, h, nt * T64, L, H);
    }
    cp_commit();  // possibly empty, so that every iteration commits one group
    if (kt == 0) {
      load_a(qa, Qs, warp * 16);
      load_a(doa, dOs, warp * 16);
    }

    // a k tile wholly after this warp's last row adds nothing to it
    if (!(causal && k0 > w0 + 15)) {
      const bf16* Kt = Ks + st * TILE;
      float s[8][4], dp[8][4];  // s then ds; dp
      zero8(s);
      zero8(dp);
      mm_a_bt<1>(&s, &qa, Kt);
      mm_a_bt<1>(&dp, &doa, Vs + st * TILE);

      const bool part = causal && k0 + T64 - 1 > w0;  // some (q, k) pairs are masked
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[j][e], sl2, -lse2[e >> 1]));
          if (part && w0 + row + (e >> 1) * 8 < k0 + j * 8 + col + (e & 1)) p = 0.f;  // q before k
          s[j][e] = p * (dp[j][e] - dl[e >> 1]) * scale;
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned a[4];
        acc_to_a(a, s[2 * kk], s[2 * kk + 1]);  // ds rounded to bf16
        mm_a_b<1>(&acc, &a, Kt, kk * 16);
      }
    }
  }

  const float one[2] = {1.f, 1.f};
  store_rows(dq, acc, one, b, h, w0, L, H);
}

// dk and dv, bfloat16; replaces `_dkv_kernel`
// (elasticdl_tpu/ops/flash_attention.py:204). Bound at the slice's
// shapes: operations (~0.017 ms), four products per (q, k) pair, so the
// design keeps all four on the tensor cores: k and v stay in registers
// as A fragments, q/do tiles and their lse/delta rows stream through a
// three-stage cp.async ring, and each warp forms the transposed
// tiles s^T = k.q^T and dp^T = v.do^T for its 16 k rows, then
// p^T = exp(s^T scale - lse) and ds^T = p^T (dp^T - delta) scale, and
// feeds both, rounded to bf16, from registers into dV += p^T.do and
// dK += ds^T.q. grid (B*H, L/64), k tiles in ascending order: the causal
// blocks with the most q tiles are dispatched first.
__global__ void __launch_bounds__(NT_TC) fa_dkv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int H,
    int causal, float scale) {
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
    cp_tile(Qs + st * TILE, q, b, h, qt * T64, L, H);
    cp_tile(dOs + st * TILE, dout, b, h, qt * T64, L, H);
    if (threadIdx.x < 32) {  // 16 copies each for lse and delta
      const int i = threadIdx.x & 15;
      const float* src = threadIdx.x < 16 ? lse : delta;
      cp_async16(rows + st * 2 * T64 + (threadIdx.x >> 4) * T64 + 4 * i,
                 src + (size_t)bh * L + qt * T64 + 4 * i);
    }
  };

  // q tiles q_first .. q_first+STAGES-2 in flight, one commit group each
  // (k and v join the first)
  cp_tile(Ks, k, b, h, k0, L, H);
  cp_tile(Vs, v, b, h, k0, L, H);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (q_first + t < n_q) load_stage(t, q_first + t);
    cp_commit();
  }

  unsigned ka[4][4], va[4][4];
  float dka[8][4], dva[8][4];
  zero8(dka);
  zero8(dva);

  for (int qt = q_first; qt < n_q; ++qt) {
    const int st = (qt - q_first) % STAGES;
    cp_wait<STAGES - 2>();  // tile qt has landed (this thread's copies)
    __syncthreads();        // ... everyone's, and the stage read at qt-1 is free
    const int nt = qt + STAGES - 1;
    if (nt < n_q) load_stage((nt - q_first) % STAGES, nt);
    cp_commit();  // possibly empty, so that every iteration commits one group
    if (qt == q_first) {
      load_a(ka, Ks, warp * 16);
      load_a(va, Vs, warp * 16);
    }
    const bf16* Qt = Qs + st * TILE;
    const bf16* dOt = dOs + st * TILE;
    const float* lse_s = rows + st * 2 * T64;
    const float* delta_s = lse_s + T64;

    float pt[8][4], dst[8][4];  // s^T then p^T; dp^T then ds^T
    zero8(pt);
    zero8(dst);
    mm_a_bt<1>(&pt, &ka, Qt);
    mm_a_bt<1>(&dst, &va, dOt);

    const bool diag = causal && qt == kt;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(&lse_s[j * 8 + col]);
      const float2 dl = *reinterpret_cast<const float2*>(&delta_s[j * 8 + col]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = (e & 1) ? ls.y : ls.x, dq = (e & 1) ? dl.y : dl.x;
        float p = ex2(fmaf(pt[j][e], sl2, -lq * LOG2E));
        if (diag && j * 8 + col + (e & 1) < row + (e >> 1) * 8) p = 0.f;  // q before k
        pt[j][e] = p;
        dst[j][e] = p * (dst[j][e] - dq) * scale;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned a[4];
      acc_to_a(a, pt[2 * kk], pt[2 * kk + 1]);  // p^T rounded to bf16
      mm_a_b<1>(&dva, &a, dOt, kk * 16);
      acc_to_a(a, dst[2 * kk], dst[2 * kk + 1]);  // ds^T rounded to bf16
      mm_a_b<1>(&dka, &a, Qt, kk * 16);
    }
  }

  const float one[2] = {1.f, 1.f};
  store_rows(dk, dka, one, b, h, k0 + warp * 16, L, H);
  store_rows(dv, dva, one, b, h, k0 + warp * 16, L, H);
}

bool bad_shape(int B, int L, int H, int Dh) {
  return Dh != D || L <= 0 || L % T64 != 0 || B <= 0 || H <= 0 || (long)B * H > 65535;
}

int launch_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int L, int H, int causal, float scale, cudaStream_t stream) {
  const size_t smem = 4 * TILE_BYTES;
  cudaError_t e = cudaFuncSetAttribute(fa_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fa_fwd_kernel<<<dim3(L / T64, B * H), NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), L, H, causal, scale);
  return (int)cudaGetLastError();
}

int launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, int B, int L, int H, int causal,
                  float scale, cudaStream_t stream) {
  const size_t smem = 5 * TILE_BYTES;
  cudaError_t e = cudaFuncSetAttribute(fa_dq_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fa_dq_kernel<<<dim3(L / T64, B * H), NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), L, H, causal, scale);
  return (int)cudaGetLastError();
}

int launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int B, int L, int H,
                   int causal, float scale, cudaStream_t stream) {
  const size_t smem = 6 * TILE_BYTES + 2 * T64 * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fa_dkv_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fa_dkv_kernel<<<dim3(L / T64, B * H), NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), L, H,
      causal, scale);
  return (int)cudaGetLastError();
}

int launch_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                    int L, int H, int causal, float scale, cudaStream_t stream) {
  // q rows and the k/v stages: 64 KB
  const size_t smem = (FWD_MT + 2 * STAGES) * TILE * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(fa_fwd_bf16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (L + T64 * FWD_MT - 1) / (T64 * FWD_MT);
  fa_fwd_bf16_kernel<<<dim3(B * H, n_qt), NT_TC, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), L, H, causal, scale);
  return (int)cudaGetLastError();
}

int launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int B, int L, int H, int causal,
                   float scale, cudaStream_t stream) {
  // q and do tiles of the block and the k/v stages: 64 KB
  const size_t smem = (2 + 2 * STAGES) * TILE * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(fa_dq_bf16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fa_dq_bf16_kernel<<<dim3(B * H, L / T64), NT_TC, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), L, H, causal, scale);
  return (int)cudaGetLastError();
}

int launch_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int B, int L, int H,
                    int causal, float scale, cudaStream_t stream) {
  // k and v tiles, the q/do stages and the lse/delta rows' stages: 65.5 KB
  const size_t smem = (2 + 2 * STAGES) * TILE * sizeof(bf16) + STAGES * 2 * T64 * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fa_dkv_bf16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fa_dkv_bf16_kernel<<<dim3(B * H, L / T64), NT_TC, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, H,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points. dtype: 0 = float32, 1 = bfloat16; the dtype alone picks
// the kernel (the CUDA-core kernel for float32, the tensor-core kernel for
// bfloat16). Each returns the cudaError_t of the
// launch (0 on success); the kernel runs on `stream`.
extern "C" {

int edl_fa_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int L,
               int H, int Dh, int causal, float scale, int dtype, void* stream) {
  if (bad_shape(B, L, H, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd_f32(q, k, v, o, lse, B, L, H, causal, scale, s);
  if (dtype == 1) return launch_fwd_bf16(q, k, v, o, lse, B, L, H, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

int edl_fa_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int L, int H, int Dh, int causal, float scale,
              int dtype, void* stream) {
  if (bad_shape(B, L, H, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dq_f32(q, k, v, dout, lse, delta, dq, B, L, H, causal, scale, s);
  if (dtype == 1) return launch_dq_bf16(q, k, v, dout, lse, delta, dq, B, L, H, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

int edl_fa_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int L, int H, int Dh, int causal,
               float scale, int dtype, void* stream) {
  if (bad_shape(B, L, H, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dkv_f32(q, k, v, dout, lse, delta, dk, dv, B, L, H, causal, scale, s);
  if (dtype == 1)
    return launch_dkv_bf16(q, k, v, dout, lse, delta, dk, dv, B, L, H, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

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
// Design: this first version is simple and far from that bound: float32
// FMAs on the CUDA cores, not the tensor cores (wgmma/TMA is later
// work). One block of 256 threads owns a 64-row tile and streams the
// other operand's 64-row tiles through shared memory, so nothing
// quadratic touches device memory and no block writes another's output
// (no atomics). Each thread holds a 4x4 register tile, so every
// shared-memory float4 read feeds four FMAs; rows are padded to 68
// floats so the float4 reads of a quarter-warp hit distinct banks.
// Causal tiles above the diagonal are skipped.

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

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision, back in float32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

__device__ __forceinline__ size_t gidx(int b, int l, int h, int d, int L, int H) {
  return (((size_t)b * L + l) * H + h) * D + d;
}

// rows [row0, row0 + 64) of head (b, h) -> s[r * LD + d] in float32
template <typename T>
__device__ __forceinline__ void load_tile(float* s, const T* g, int b, int h, int row0,
                                          int L, int H) {
  for (int idx = threadIdx.x; idx < T64 * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    s[r * LD + d] = to_f32<T>(g[gidx(b, row0 + r, h, d, L, H)]);
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
// shapes: bytes (~0.010 ms).
template <typename T>
__global__ void __launch_bounds__(NT) fa_fwd_kernel(const T* __restrict__ q,
                                                    const T* __restrict__ k,
                                                    const T* __restrict__ v,
                                                    T* __restrict__ o,
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

  load_tile<T>(Qs, q, b, h, q0, L, H);
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
    load_tile<T>(Ks, k, b, h, k0, L, H);
    load_tile<T>(Vs, v, b, h, k0, L, H);
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
        Ps[(ty * 4 + i) * LD + tx + 16 * j] = round_to<T>(p);
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
    for (int j = 0; j < 4; ++j) o[gidx(b, r, h, tx * 4 + j, L, H)] = from_f32<T>(acc[i][j] / l[i]);
    if (tx == 0) lse[(size_t)bh * L + r] = m[i] + logf(l[i]);
  }
}

// dq; replaces `_dq_kernel` (elasticdl_tpu/ops/flash_attention.py:161).
// grid (L/64, B*H): one block per (head, 64-row q tile); k/v tiles stream.
// Bound at the slice's shapes: operations (~0.013 ms).
template <typename T>
__global__ void __launch_bounds__(NT) fa_dq_kernel(const T* __restrict__ q,
                                                   const T* __restrict__ k,
                                                   const T* __restrict__ v,
                                                   const T* __restrict__ dout,
                                                   const float* __restrict__ lse,
                                                   const float* __restrict__ delta,
                                                   T* __restrict__ dq, int L, int H,
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

  load_tile<T>(Qs, q, b, h, q0, L, H);
  load_tile<T>(dOs, dout, b, h, q0, L, H);
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
    load_tile<T>(Ks, k, b, h, k0, L, H);
    load_tile<T>(Vs, v, b, h, k0, L, H);
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
        DSs[(ty * 4 + i) * LD + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - delta_r[i]) * scale);
      }
    __syncthreads();
    mm_nn(DSs, Ks, acc, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dq[gidx(b, q0 + ty * 4 + i, h, tx * 4 + j, L, H)] = from_f32<T>(acc[i][j]);
}

// dk and dv; replaces `_dkv_kernel` (elasticdl_tpu/ops/flash_attention.py:204).
// grid (L/64, B*H): one block per (head, 64-row k tile); k and v stay
// resident while q tiles stream past; no atomics. Bound at the slice's
// shapes: operations (~0.017 ms).
template <typename T>
__global__ void __launch_bounds__(NT) fa_dkv_kernel(const T* __restrict__ q,
                                                    const T* __restrict__ k,
                                                    const T* __restrict__ v,
                                                    const T* __restrict__ dout,
                                                    const float* __restrict__ lse,
                                                    const float* __restrict__ delta,
                                                    T* __restrict__ dk, T* __restrict__ dv,
                                                    int L, int H, int causal, float scale) {
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

  load_tile<T>(Ks, k, b, h, k0, L, H);
  load_tile<T>(Vs, v, b, h, k0, L, H);
  float dk_acc[4][4], dv_acc[4][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int qt = causal ? kt : 0; qt < L / T64; ++qt) {
    const int q0 = qt * T64;
    __syncthreads();
    load_tile<T>(Qs, q, b, h, q0, L, H);
    load_tile<T>(dOs, dout, b, h, q0, L, H);
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
        Ps[(ty * 4 + i) * LD + r] = round_to<T>(p);
        DSs[(ty * 4 + i) * LD + r] = round_to<T>(p * (dpt[i][j] - delta_s[r]) * scale);
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
      dk[g] = from_f32<T>(dk_acc[i][j]);
      dv[g] = from_f32<T>(dv_acc[i][j]);
    }
}

bool bad_shape(int B, int L, int H, int Dh) {
  return Dh != D || L <= 0 || L % T64 != 0 || B <= 0 || H <= 0 || (long)B * H > 65535;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int L,
               int H, int causal, float scale, cudaStream_t stream) {
  const size_t smem = 4 * TILE_BYTES;
  cudaError_t e = cudaFuncSetAttribute(fa_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fa_fwd_kernel<T><<<dim3(L / T64, B * H), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), L, H, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int L, int H, int causal, float scale,
              cudaStream_t stream) {
  const size_t smem = 5 * TILE_BYTES;
  cudaError_t e = cudaFuncSetAttribute(fa_dq_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fa_dq_kernel<T><<<dim3(L / T64, B * H), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), L, H, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int L, int H, int causal,
               float scale, cudaStream_t stream) {
  const size_t smem = 6 * TILE_BYTES + 2 * T64 * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fa_dkv_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fa_dkv_kernel<T><<<dim3(L / T64, B * H), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), L, H, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points. dtype: 0 = float32, 1 = bfloat16. Each returns the
// cudaError_t of the launch (0 on success); the kernel runs on `stream`.
extern "C" {

int edl_fa_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int L,
               int H, int Dh, int causal, float scale, int dtype, void* stream) {
  if (bad_shape(B, L, H, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(q, k, v, o, lse, B, L, H, causal, scale, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(q, k, v, o, lse, B, L, H, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

int edl_fa_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int L, int H, int Dh, int causal, float scale,
              int dtype, void* stream) {
  if (bad_shape(B, L, H, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dq<float>(q, k, v, dout, lse, delta, dq, B, L, H, causal, scale, s);
  if (dtype == 1)
    return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, L, H, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

int edl_fa_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int L, int H, int Dh, int causal,
               float scale, int dtype, void* stream) {
  if (bad_shape(B, L, H, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, B, L, H, causal, scale, s);
  if (dtype == 1)
    return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B, L, H, causal,
                                     scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

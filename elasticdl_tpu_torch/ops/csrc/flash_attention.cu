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
// Layout: q, k, v, o, do, dq, dk, dv are [B, L, H, D] contiguous, D = 16,
// 32, 64 or 128 (every kernel is a template on D), L a multiple of 64; lse
// and delta are float32 [B, H, L].
//
// Bound: at the training slices' shapes (bf16, causal: b8 x s1024 with
// 8 heads of 64, b16 x s1024 with 8 heads of 128) the forward does about
// 250 (D = 64) or 255 (D = 128) operations per byte it must move and the
// backward kernels 300-400, against the card's balance of about 295 for
// bf16 tensor cores: the forward is bound by bytes, the backward kernels
// by operations. Each kernel also takes one exp2 per visible (q, k) pair
// on the special-function units (16 a clock per SM): at D = 16 and 32 the
// products and bytes shrink with D and the exponentials bind every
// kernel (chip_smoke.py computes and prints each bound's three terms).
//
// Every kernel: one block owns a tile of rows of one (batch, head) (64
// rows; the bf16 forward at D <= 64: 128; the f32 kernels: 16 to 128 by
// head dim) and streams the other operand's tiles past it, so nothing quadratic
// touches device memory and no block writes another's output (no
// atomics). Causal tiles above the diagonal are skipped; only the rows
// near the diagonal compare positions.
//
// Two designs, chosen by dtype in the C entry points, never on failure:
//
// - bfloat16 (`fa_fwd_bf16_kernel`, `fa_dq_bf16_kernel`,
//   `fa_dkv_bf16_kernel`): the products run on the tensor cores
//   (`mma.sync.m16n8k16` bf16 x bf16 -> f32). Streamed tiles stay bf16 in
//   shared memory (64 x D: 2 KB at D = 16 up to 16 KB at D = 128; 16-byte
//   chunks XOR-swizzled by row so `ldmatrix` reads are free of bank
//   conflicts, `swz`) and arrive by 16-byte `cp.async` into a ring of
//   stages, the next tiles' copies in flight while the current one is
//   multiplied. Each of 4 warps owns 16 q rows (dq; the forward: 32 at
//   D <= 64, 16 at D = 128) or 16 k rows (dk+dv); the score accumulator
//   of m16n8 is the A-operand layout of m16n8k16, so p and ds are rounded
//   to bf16 and fed to the next product from registers, with no trip
//   through shared memory. `Tc<D>` sets what differs by head dim: at
//   D = 128 a D-wide accumulator takes 64 registers a thread, so the
//   forward keeps one row tile a warp, dq and dk+dv hold the scores of 32
//   k (q) columns at a time instead of 64, dk+dv reads k and v from shared
//   memory at each use instead of keeping them in registers, and the ring
//   has two stages instead of three, so two blocks fit an SM. At D = 16
//   and 32 tiles and accumulators are small and the exponentials take the
//   time; a deeper ring gained nothing there, so it has two stages too.
// - float32 (`fa_fwd_kernel`, `fa_dq_kernel`, `fa_dkv_kernel`): float32
//   FMAs on the CUDA cores, bound by the products at their 67 TFLOP/s (the
//   one exp2 per pair comes second in f32). The tensor cores would take
//   f32 only as TF32 (about 3 decimal digits), so f32 stays on this path.
//   All three give each resident row (q in the forward and dq, k in
//   dk+dv) to D / 16 lanes, 16 dims each in registers with its
//   accumulators, and stream the other rows' tiles through a cp.async
//   ring; every lane of a warp reads the same streamed row (a
//   shared-memory broadcast) and keeps p and ds in registers, so the walk
//   spends its issue slots on FMAs (a lane holds 16 dims of two resident
//   rows, four in the forward at D = 32: 128 FMAs in dk+dv, 64 in the
//   forward, for 8 16-byte shared loads), with one barrier a tile. The
//   forward's online softmax goes by steps of C streamed rows, one max
//   and one correction a row a step. `fc<D>` and `cc<D, W>` split
//   each streamed tile's rows over S thread groups so that small heads
//   still fill the SMs (the groups' partial sums, in the forward their
//   partial (m, l, acc), are merged in a fixed order), and a causal block
//   takes row tiles y and n - 1 - y, so all do equal work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int T64 = 64;       // rows per tile (q and k)
constexpr float NEG_INF = -1e30f;

template <int D>
__device__ __forceinline__ size_t gidx(int b, int l, int h, int d, int L, int H) {
  return (((size_t)b * L + l) * H + h) * D + d;
}

// ------------------------------------------------ bfloat16, tensor cores

using bf16 = __nv_bfloat16;

constexpr int NT_TC = 128;  // threads per block: 4 warps
constexpr float LOG2E = 1.4426950408889634f;

// The bf16 kernels' tiling by head dim (registers a thread and shared
// memory a block; PERF.md gives ptxas's counts and the blocks an SM holds).
// At D = 16 and 32 a 64 x D tile is 2 or 4 KB and a 16 x D accumulator 8
// or 16 registers, so any depth of the ring fits; but the exponentials,
// not the copies, take the time there: rings of 2, 3 and 4 stages ran
// alike on the card (within the spread of one run), so the smallest is
// kept, and a forward of 4 row tiles a warp ran slower at D = 16 and
// spilled at 32 (scripts/torch_attention_tilings.py, PERF.md).
template <int D>
struct Tc;
template <>
struct Tc<16> {
  static constexpr int STAGES = 2;  // depth of the cp.async ring of streamed tiles
  static constexpr int FWD_MT = 2;  // forward: 16-row q tiles a warp (128 q rows a block)
  static constexpr int KW = 64;     // dq, dk+dv: score columns a warp holds at once
  static constexpr bool KV_REGS = true;  // dk+dv: k and v as register A fragments
};
template <>
struct Tc<32> {
  static constexpr int STAGES = 2;
  static constexpr int FWD_MT = 2;
  static constexpr int KW = 64;
  static constexpr bool KV_REGS = true;
};
template <>
struct Tc<64> {
  static constexpr int STAGES = 3;
  static constexpr int FWD_MT = 2;
  static constexpr int KW = 64;
  static constexpr bool KV_REGS = true;
};
template <>
struct Tc<128> {
  static constexpr int STAGES = 2;
  static constexpr int FWD_MT = 1;
  static constexpr int KW = 32;
  static constexpr bool KV_REGS = false;
};

// Offset of element (r, c) in a swizzled 64 x D bf16 tile: row r's
// 16-byte chunk c/8 (of CH = D/8) sits at chunk (c/8) ^ x(r). Every
// ldmatrix phase reads one chunk column of 8 consecutive rows from a
// multiple of 8, and those 8 chunks must land in the 8 distinct 16-byte
// bank groups of a 128-byte bank cycle. At D >= 64 a row is a whole number
// of cycles and x(r) = r % 8 spreads them. At D = 32 two rows share a
// cycle (the second sits 4 groups on) and at D = 16 four do (2 groups
// apart), so x(r) = (r / RPC) % CH, RPC rows a cycle, spreads the rows
// that share a group offset over the CH chunks a row has; an XOR with
// r % 8 there would move a chunk past its row's end, into the next row.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CH = D / 8, RPC = CH >= 8 ? 1 : 8 / CH, X = CH >= 8 ? 8 : CH;
  return r * D + (((c >> 3) ^ ((r / RPC) % X)) << 3) + (c & 7);
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
  static_assert(T64 * CH % NT_TC == 0, "every thread copies the same number of chunks");
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
// stored in natural log. Each warp owns MT row tiles of 16: at D <= 64
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
  static_assert(BM * CH % NT_TC == 0, "every thread copies the same number of q chunks");
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
            if (j < D / 8) acc[mt][j][e] *= corr[e >> 1];  // D / 8 is 2 at D = 16
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
// into dV += p^T.do and dK += ds^T.q. At D <= 64 k and v sit in registers
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
  constexpr bool KV_REGS = Tc<D>::KV_REGS;
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

// --------------------------------------------- float32 backward, CUDA cores

// Each thread of the f32 backward kernels holds DL = 16 dims of MR = 2
// resident rows (q rows in dq, k rows in dk+dv) with their accumulators;
// R = D / 16 neighbouring lanes share a row, so a warp holds 64 / R rows.
// A block of 128 threads is S groups, each holding the block's RB = (128 /
// S) 2 / R rows; group g takes rows [g TS / S, (g + 1) TS / S) of every
// streamed tile of TS rows (which all groups share, brought by a cp.async
// ring of STAGES), and the S partial sums are added in group order at the
// end. With AHEAD, the walk reads the next streamed row while it uses
// this one: dq gained 4% from it at D = 16, lost 8% at 32 and spilled at
// 64 and 128; dk+dv lost 12% at 16. Two blocks an SM (__launch_bounds__:
// up to 255 registers).
//
// What bounds them on this card: the products, and behind them the
// streamed floats every lane takes from shared memory. A broadcast read
// costs per float it delivers to each lane (four LDS.32 ran as one
// LDS.128), and a loop feeding FMAs that way reached 0.48 (32 FMAs a
// 16-float row) to 0.63 (64) of the card's 67 TFLOP/s, well under what
// FMAs alone reach (scripts/torch_f32_fma_rates.py, PERF.md). A lane reads
// 32 floats a streamed row and does 96 (dq) or 128 (dk+dv) FMAs with
// them; with one resident row a thread, half that, dq ran at 0.19 of its
// bound. More rows, or 8 dims a lane, did not fit the registers or paid
// the shuffles back. The settings by head dim were timed by
// scripts/torch_attention_f32_turns.py.
constexpr int NT_F32 = 128;  // threads a block
constexpr int DL = 16;       // dims of a resident row a lane holds
constexpr int MR = 2;        // resident rows a thread holds

struct Cc {
  int S, TS, STAGES, AHEAD;
};
template <int D, int W>  // W: 1 dq, 2 dk+dv
__host__ __device__ constexpr Cc cc();
//                                                         S  TS STAGES AHEAD
template <> __host__ __device__ constexpr Cc cc<16, 1>() { return {4, 64, 3, 1}; }
template <> __host__ __device__ constexpr Cc cc<16, 2>() { return {4, 64, 3, 0}; }
template <> __host__ __device__ constexpr Cc cc<32, 1>() { return {4, 64, 3, 0}; }
template <> __host__ __device__ constexpr Cc cc<32, 2>() { return {4, 64, 3, 0}; }
template <> __host__ __device__ constexpr Cc cc<64, 1>() { return {2, 64, 3, 0}; }
template <> __host__ __device__ constexpr Cc cc<64, 2>() { return {2, 64, 2, 0}; }
template <> __host__ __device__ constexpr Cc cc<128, 1>() { return {2, 32, 2, 0}; }
template <> __host__ __device__ constexpr Cc cc<128, 2>() { return {2, 32, 2, 0}; }

template <int D, int W>
__host__ __device__ constexpr int rows_of() {  // RB, the resident rows of a block
  return NT_F32 / cc<D, W>().S * MR / (D / DL);
}

// The row tiles a block takes: one, or when causal two, y and n - 1 - y,
// which see n + 1 streamed tiles together, so every block of the causal
// grid has the same work (the middle tile of an odd n alone, dispatched
// last). The launch's grid height for n row tiles.
__host__ __device__ constexpr int row_blocks(int n, int causal) { return causal ? (n + 1) / 2 : n; }

// Float offset of 16-byte chunk c (0..3) of 16-dim slice j in a row of a
// streamed f32 tile. The R lanes of a resident row read their slices of
// one streamed row together, 64 bytes apart; at D >= 64 (two slices a
// 128-byte bank cycle) chunk c of slice j sits at c ^ ((j / 2) % 4) within
// its slice, so those R reads fall in distinct 16-byte bank groups.
__device__ __forceinline__ int slice_off(int j, int c) {
  return 4 * (4 * j + (c ^ ((j >> 1) & 3)));
}

// rows [row0, row0 + TS) of head (b, h) -> f32 tile, rows of D floats with
// slice_off's chunk order, 16 bytes a copy
template <int D, int TS>
__device__ __forceinline__ void cp_tile_f32(float* s, const float* g, int b, int h, int row0,
                                            int L, int H) {
  constexpr int CH = D / 4;  // 16-byte chunks a row
  static_assert(TS * CH % NT_F32 == 0, "every thread copies the same number of chunks");
#pragma unroll
  for (int it = 0; it < TS * CH / NT_F32; ++it) {
    const int i = it * NT_F32 + threadIdx.x, r = i / CH, ch = i % CH;
    cp_async16(s + r * D + slice_off(ch >> 2, ch & 3), g + gidx<D>(b, row0 + r, h, 4 * ch, L, H));
  }
}

// 16 floats: from device memory (contiguous), from slice j of a streamed
// tile's row, to device memory times `scale`
__device__ __forceinline__ void ldg16(float* x, const float* g) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(g) + c);
    x[4 * c] = t.x, x[4 * c + 1] = t.y, x[4 * c + 2] = t.z, x[4 * c + 3] = t.w;
  }
}
__device__ __forceinline__ void lds16(float* x, const float* row, int j) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 t = *reinterpret_cast<const float4*>(row + slice_off(j, c));
    x[4 * c] = t.x, x[4 * c + 1] = t.y, x[4 * c + 2] = t.z, x[4 * c + 3] = t.w;
  }
}
__device__ __forceinline__ void stg16(float* g, const float* x, float scale) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    reinterpret_cast<float4*>(g)[c] = make_float4(x[4 * c] * scale, x[4 * c + 1] * scale,
                                                  x[4 * c + 2] * scale, x[4 * c + 3] * scale);
}

// For each resident row i: s[i] = a[i].x and dp[i] = b[i].y over this
// lane's 16 dims (two chains each), then summed over the R lanes of the
// row by an XOR butterfly, which leaves the same bits in each of them
template <int R>
__device__ __forceinline__ void dots(const float (*a)[DL], const float* x, const float (*b)[DL],
                                     const float* y, float* s, float* dp) {
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    float s0 = 0.f, s1 = 0.f, d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int e = 0; e < DL; e += 2) {
      s0 = fmaf(a[i][e], x[e], s0);
      s1 = fmaf(a[i][e + 1], x[e + 1], s1);
      d0 = fmaf(b[i][e], y[e], d0);
      d1 = fmaf(b[i][e + 1], y[e + 1], d1);
    }
    s[i] = s0 + s1;
    dp[i] = d0 + d1;
  }
#pragma unroll
  for (int o = 1; o < R; o <<= 1)
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
      dp[i] += __shfl_xor_sync(0xffffffffu, dp[i], o);
    }
}

// Rows [ra, rb) of a streamed tile, whose two operands' rows start at X and
// Y: this lane's slice j of both rows is read into registers (with AHEAD
// one row ahead of its use, in two register sets), then pair(x, y, r)
// runs on it
template <int D, bool AHEAD, typename F>
__device__ __forceinline__ void walk(const float* X, const float* Y, int j, int ra, int rb,
                                     F&& pair) {
  if constexpr (!AHEAD) {
    for (int r = ra; r < rb; ++r) {
      float x[DL], y[DL];
      lds16(x, X + r * D, j);
      lds16(y, Y + r * D, j);
      pair(x, y, r);
    }
  } else {
    if (ra >= rb) return;
    float x[2][DL], y[2][DL];
    lds16(x[0], X + ra * D, j);
    lds16(y[0], Y + ra * D, j);
    for (int r = ra; r < rb; r += 2) {
      if (r + 1 < rb) {
        lds16(x[1], X + (r + 1) * D, j);
        lds16(y[1], Y + (r + 1) * D, j);
      }
      pair(x[0], y[0], r);
      if (r + 1 < rb) {
        if (r + 2 < rb) {
          lds16(x[0], X + (r + 2) * D, j);
          lds16(y[0], Y + (r + 2) * D, j);
        }
        pair(x[1], y[1], r + 1);
      }
    }
  }
}

// The S groups' partial sums of N accumulator floats (acc), added into
// group 0's in group order (the same bits every run) through shared
// memory `smem`, once every group is done with it. Returns whether this
// thread holds the sums (group 0).
template <int S, int N>
__device__ __forceinline__ bool sum_groups(float4* smem, float* acc) {
  if constexpr (S == 1) {
    return true;
  } else {
    constexpr int GT = NT_F32 / S;  // threads a group
    const int t = threadIdx.x % GT, g = threadIdx.x / GT;
    cp_wait<0>();
    __syncthreads();
    if (g > 0)  // [S - 1][N / 4 chunks][GT]: neighbouring threads, neighbouring chunks
#pragma unroll
      for (int c = 0; c < N / 4; ++c)
        smem[((g - 1) * (N / 4) + c) * GT + t] =
            make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]);
    __syncthreads();
    if (g > 0) return false;
#pragma unroll 1
    for (int p = 0; p < S - 1; ++p)
#pragma unroll
      for (int c = 0; c < N / 4; ++c) {
        const float4 x = smem[(p * (N / 4) + c) * GT + t];
        acc[4 * c] += x.x, acc[4 * c + 1] += x.y, acc[4 * c + 2] += x.z, acc[4 * c + 3] += x.w;
      }
    return true;
  }
}

// dq, float32; replaces `_dq_kernel` (elasticdl_tpu/ops/flash_attention.py:161).
// Bound by the products on the CUDA cores (three D-long products per
// visible (q, k) pair at 67 TFLOP/s; the one exp2 per pair comes second in
// f32) and, behind them, by the streamed k and v floats each lane takes
// from shared memory. Each thread holds 16 dims of 2 q rows in registers:
// q (scaled by scale * log2 e, so s comes out in base 2), do and the dq
// accumulator, with each row's lse (base 2) and delta, and walks the k
// rows they see. Every row group of a warp reads the same k and v row of
// the streamed tile with 16-byte shared loads (a broadcast), forms s and
// dp for its 2 rows (summed over the row's R lanes by shuffles at D >=
// 32), then p = exp2(s - lse) and ds = p (dp - delta), and adds ds k into
// its accumulators: p and ds never leave registers, and the walk has one
// barrier a tile. k/v tiles arrive by cp.async STAGES - 1 tiles ahead; the
// S groups of a block take a share of every tile's k rows each and add
// their partial dq in group order at the end (no atomics). The scale is
// applied once, to the sum. grid (B*H, row_blocks): a causal block takes
// q tiles y and n - 1 - y. Only the k rows after a warp's first q row
// compare positions.
template <int D>
__global__ void __launch_bounds__(NT_F32, 2) fa_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int L, int H, int causal,
    float scale) {
  constexpr Cc C = cc<D, 1>();
  constexpr int S = C.S, TS = C.TS, STAGES = C.STAGES, R = D / DL, RW = 32 * MR / R;
  constexpr int GT = NT_F32 / S, RB = rows_of<D, 1>(), TILE = TS * D;
  static_assert(GT % 32 == 0 && TS % S == 0 && T64 % TS == 0 && T64 % RB == 0,
                "groups of whole warps, tiles that divide 64 rows");
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // STAGES x (k tile, v tile)
  const int bh = blockIdx.x, b = bh / H, h = bh % H, n_rb = L / RB, y = blockIdx.y;
  const int t = threadIdx.x % GT, g = threadIdx.x / GT, lane = t % 32, j = lane % R;
  const float sl2 = scale * LOG2E;
  const int items = causal && 2 * y + 1 < n_rb ? 2 : 1;

  for (int item = 0; item < items; ++item) {
    const int q0 = (item == 1 ? n_rb - 1 - y : y) * RB;
    const int w0 = q0 + t / 32 * RW, wl = w0 + RW - 1;  // this warp's first and last q rows
    const int row0 = w0 + lane / R;  // this thread's q rows: row0 and row0 + 32 / R
    const int n_t = causal ? (q0 + RB - 1) / TS + 1 : L / TS;
    if (item > 0) {
      cp_wait<0>();
      __syncthreads();  // the last row tile is done with the ring and the sums
    }
    auto load_stage = [&](int st, int kt) {
      cp_tile_f32<D, TS>(ring + st * 2 * TILE, k, b, h, kt * TS, L, H);
      cp_tile_f32<D, TS>(ring + st * 2 * TILE + TILE, v, b, h, kt * TS, L, H);
    };
    // k/v tiles 0 .. STAGES-2 in flight, one commit group each
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < n_t) load_stage(i, i);
      cp_commit();
    }

    float qx[MR][DL], dox[MR][DL], acc[MR][DL], lse2[MR], dl[MR];
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int r = row0 + i * (32 / R);
      ldg16(qx[i], q + gidx<D>(b, r, h, DL * j, L, H));
      ldg16(dox[i], dout + gidx<D>(b, r, h, DL * j, L, H));
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        qx[i][e] *= sl2;
        acc[i][e] = 0.f;
      }
      lse2[i] = lse[(size_t)bh * L + r] * LOG2E;
      dl[i] = delta[(size_t)bh * L + r];
    }

    for (int kt = 0; kt < n_t; ++kt) {
      const int st = kt % STAGES, k0 = kt * TS;
      cp_wait<STAGES - 2>();  // tile kt has landed (this thread's copies)
      __syncthreads();        // ... everyone's, and the stage read at kt-1 is free
      const int nt = kt + STAGES - 1;
      if (nt < n_t) load_stage(nt % STAGES, nt);
      cp_commit();  // possibly empty, so that every iteration commits one group
      const float* Kt = ring + st * 2 * TILE;
      const float* Vt = Kt + TILE;

      auto pair = [&](const float* kx, const float* vx, int r, bool mask) {
        float s[MR], dp[MR];
        dots<R>(qx, kx, dox, vx, s, dp);
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          float p = ex2(s[i] - lse2[i]);
          if (mask && k0 + r > row0 + i * (32 / R)) p = 0.f;  // k after q
          const float ds = p * (dp[i] - dl[i]);
#pragma unroll
          for (int e = 0; e < DL; ++e) acc[i][e] = fmaf(ds, kx[e], acc[i][e]);
        }
      };
      // this group's k rows of the tile, [ra, rb); when causal, rows after
      // the warp's last q row add nothing to it and rows up to its first
      // need no mask
      const int ra = g * (TS / S);
      int rb = ra + TS / S, rm = rb;
      if (causal) {
        rb = min(rb, wl + 1 - k0);
        rm = max(ra, min(rb, w0 + 1 - k0));
      }
      walk<D, C.AHEAD>(Kt, Vt, j, ra, rm,
                       [&](const float* kx, const float* vx, int r) { pair(kx, vx, r, false); });
      walk<D, C.AHEAD>(Kt, Vt, j, rm, rb,
                       [&](const float* kx, const float* vx, int r) { pair(kx, vx, r, true); });
    }

    if (sum_groups<S, MR * DL>(smem4, &acc[0][0]))
#pragma unroll
      for (int i = 0; i < MR; ++i)
        stg16(dq + gidx<D>(b, row0 + i * (32 / R), h, DL * j, L, H), acc[i], scale);
  }
}

// dk and dv, float32; replaces `_dkv_kernel`
// (elasticdl_tpu/ops/flash_attention.py:204). Bound by the products on
// the CUDA cores (four D-long products per visible pair) and, behind
// them, by the streamed q and do floats each lane takes from shared
// memory. As dq, each thread holds 16 dims of 2 k rows in registers: k
// (scaled by scale * log2 e), v and the dk and dv accumulators, and walks
// the q rows that see them. Every row group of a warp reads the same q and
// do row (a broadcast) and that row's lse and delta, forms s and dp for
// its 2 rows, p = exp2(s - lse log2 e) and ds = p (dp - delta), and adds p
// do into dv and ds q into dk: 128 FMAs for 34 shared floats, with p and
// ds in registers throughout. q/do tiles and their lse/delta rows arrive
// by cp.async STAGES - 1 tiles ahead; the S groups of a block split every
// tile's q rows and add their partial dk and dv in group order at the
// end. grid (B*H, row_blocks): a causal block takes k tiles y and n - 1 -
// y. Only the q rows up to a warp's last k row compare positions.
template <int D>
__global__ void __launch_bounds__(NT_F32, 2) fa_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int L, int H,
    int causal, float scale) {
  constexpr Cc C = cc<D, 2>();
  constexpr int S = C.S, TS = C.TS, STAGES = C.STAGES, R = D / DL, RW = 32 * MR / R;
  constexpr int GT = NT_F32 / S, RB = rows_of<D, 2>(), TILE = TS * D, STAGE = 2 * TILE + 2 * TS;
  static_assert(GT % 32 == 0 && TS % S == 0 && T64 % TS == 0 && T64 % RB == 0,
                "groups of whole warps, tiles that divide 64 rows");
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // STAGES x (q tile, do tile, lse, delta)
  const int bh = blockIdx.x, b = bh / H, h = bh % H, n_rb = L / RB, y = blockIdx.y;
  const int t = threadIdx.x % GT, g = threadIdx.x / GT, lane = t % 32, j = lane % R;
  const float sl2 = scale * LOG2E;
  const int items = causal && 2 * y + 1 < n_rb ? 2 : 1;

  for (int item = 0; item < items; ++item) {
    const int k0 = (item == 1 ? n_rb - 1 - y : y) * RB;
    const int w0 = k0 + t / 32 * RW, wl = w0 + RW - 1;  // this warp's first and last k rows
    const int row0 = w0 + lane / R;  // this thread's k rows: row0 and row0 + 32 / R
    const int n_t = L / TS, t_first = causal ? k0 / TS : 0;
    if (item > 0) {
      cp_wait<0>();
      __syncthreads();  // the last row tile is done with the ring and the sums
    }
    auto load_stage = [&](int st, int qt) {
      float* s = ring + st * STAGE;
      cp_tile_f32<D, TS>(s, q, b, h, qt * TS, L, H);
      cp_tile_f32<D, TS>(s + TILE, dout, b, h, qt * TS, L, H);
      if (threadIdx.x < TS / 2) {  // TS / 4 copies each for lse and delta
        const int i = threadIdx.x % (TS / 4), which = threadIdx.x / (TS / 4);
        cp_async16(s + 2 * TILE + which * TS + 4 * i,
                   (which ? delta : lse) + (size_t)bh * L + qt * TS + 4 * i);
      }
    };
    // q tiles t_first .. t_first+STAGES-2 in flight, one commit group each
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (t_first + i < n_t) load_stage(i, t_first + i);
      cp_commit();
    }

    float kx[MR][DL], vx[MR][DL], acc[2][MR][DL];  // acc: dk, dv
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int r = row0 + i * (32 / R);
      ldg16(kx[i], k + gidx<D>(b, r, h, DL * j, L, H));
      ldg16(vx[i], v + gidx<D>(b, r, h, DL * j, L, H));
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        kx[i][e] *= sl2;
        acc[0][i][e] = acc[1][i][e] = 0.f;
      }
    }

    for (int qt = t_first; qt < n_t; ++qt) {
      const int st = (qt - t_first) % STAGES, q0 = qt * TS;
      cp_wait<STAGES - 2>();  // tile qt has landed (this thread's copies)
      __syncthreads();        // ... everyone's, and the stage read at qt-1 is free
      const int nt = qt + STAGES - 1;
      if (nt < n_t) load_stage((nt - t_first) % STAGES, nt);
      cp_commit();  // possibly empty, so that every iteration commits one group
      const float* Qt = ring + st * STAGE;
      const float* dOt = Qt + TILE;
      const float* ls = dOt + TILE;
      const float* dls = ls + TS;

      auto pair = [&](const float* qx, const float* dox, int r, bool mask) {
        float s[MR], dp[MR];
        dots<R>(kx, qx, vx, dox, s, dp);
        const float lq = ls[r] * LOG2E, dq = dls[r];
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          float p = ex2(s[i] - lq);
          if (mask && q0 + r < row0 + i * (32 / R)) p = 0.f;  // q before k
          const float ds = p * (dp[i] - dq);
#pragma unroll
          for (int e = 0; e < DL; ++e) {
            acc[0][i][e] = fmaf(ds, qx[e], acc[0][i][e]);
            acc[1][i][e] = fmaf(p, dox[e], acc[1][i][e]);
          }
        }
      };
      // this group's q rows of the tile, [ra, rb); when causal, rows before
      // the warp's first k row see none of it and rows after its last need
      // no mask
      int ra = g * (TS / S), rm = ra;
      const int rb = ra + TS / S;
      if (causal) {
        ra = max(ra, w0 - q0);
        rm = max(ra, min(rb, wl + 1 - q0));
      }
      walk<D, C.AHEAD>(Qt, dOt, j, ra, rm,
                       [&](const float* qx, const float* dox, int r) { pair(qx, dox, r, true); });
      walk<D, C.AHEAD>(Qt, dOt, j, rm, rb,
                       [&](const float* qx, const float* dox, int r) { pair(qx, dox, r, false); });
    }

    if (sum_groups<S, 2 * MR * DL>(smem4, &acc[0][0][0]))
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const size_t o = gidx<D>(b, row0 + i * (32 / R), h, DL * j, L, H);
        stg16(dk + o, acc[0][i], scale);
        stg16(dv + o, acc[1][i], 1.f);
      }
  }
}

// ---------------------------------------------- float32 forward, CUDA cores

// The f32 forward carries the f32 backward's design over: each thread
// holds DL = 16 dims of MR resident q rows (scaled by scale * log2 e) with
// their o accumulators, running max m and sum l in registers, R = D / 16
// lanes share a row, and the k and v rows stream past as shared-memory
// broadcasts from a cp.async ring. The online softmax goes by steps of C
// streamed rows: C scores a row in registers, one new max and one
// correction exp2 a row a step, then p = exp2(s - m) and acc += p v (a
// correction per streamed row would rescale D accumulators per k row and
// double the pv FMAs); p never leaves registers. `fc<D>` sets by head dim
// MR, the S thread groups that split each streamed tile, the tile rows TS,
// the ring depth and C; a block holds RB = 128 / S * MR / R q rows (which
// must divide 64), all of which every group holds.
//
// What bounds it on this card: not the streamed floats a lane takes from
// shared memory, which bound the f32 backward. Four rows a thread (64 FMAs
// a 16-float broadcast row instead of 32) ran slower at D = 16 and 64 and
// spilled at 128 (at 32 they fit with C = 4 and won), and a lane holding 8
// dims of four rows, which halves the floats a FMA, was slower at every
// head dim. The time follows the instructions a pair issues
// (two D-long products and, per row, a max, an exp2, a subtraction and an
// addition), issued at about half the scheduler's rate with the two warps
// a scheduler that the registers and, at the zoo's [8, 1024, 4, 16], the
// grid allow. The settings by head dim were timed by
// scripts/torch_attention_f32_turns.py (PERF.md).
struct Fc {
  int MR, S, TS, STAGES, C;
};
template <int D>
__host__ __device__ constexpr Fc fc();
//                                                      MR  S  TS STAGES  C
template <> __host__ __device__ constexpr Fc fc<16>() { return {2, 4, 64, 3, 8}; }
template <> __host__ __device__ constexpr Fc fc<32>() { return {4, 4, 64, 3, 4}; }
template <> __host__ __device__ constexpr Fc fc<64>() { return {2, 2, 64, 3, 8}; }
template <> __host__ __device__ constexpr Fc fc<128>() { return {2, 2, 32, 2, 8}; }

template <int D>
__host__ __device__ constexpr int fwd_rows() {  // RB, the resident rows of a block
  return NT_F32 / fc<D>().S * fc<D>().MR / (D / DL);
}

constexpr float LN2 = 0.6931471805599453f;

// The max and the sum of x[0 .. C) by pairs, so that no chain runs
// through all C
template <int C>
__device__ __forceinline__ float max_of(const float* x) {
  if constexpr (C == 1) return x[0];
  else return fmaxf(max_of<C / 2>(x), max_of<C / 2>(x + C / 2));
}
template <int C>
__device__ __forceinline__ float sum_of(const float* x) {
  if constexpr (C == 1) return x[0];
  else return sum_of<C / 2>(x) + sum_of<C / 2>(x + C / 2);
}

// One online-softmax step over C streamed rows, whose k and v rows start
// at K and V, for the thread's M resident rows (qx, with acc, m and l):
// this lane's 16 dims of each row's C scores (two chains each), summed
// over the row's R lanes by an XOR butterfly (the same bits in each lane);
// the new max m and the correction exp2(m_old - m) of l and acc; then p =
// exp2(s - m) into l and acc += p v. With EDGE, only the first n rows
// count, and row c only for the resident rows it does not follow: its
// position kp + c is at most the row's, qp + i (32 / R).
template <int R, int M, int C, bool EDGE>
__device__ __forceinline__ void fwd_step(const float (*qx)[DL], float (*acc)[DL], float* m,
                                         float* l, const float* K, const float* V, int j, int n,
                                         int kp, int qp) {
  constexpr int D = R * DL;
  float s[M][C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float x[DL];
    if (EDGE && c >= n) continue;
    lds16(x, K + c * D, j);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int e = 0; e < DL; e += 2) {
        s0 = fmaf(qx[i][e], x[e], s0);
        s1 = fmaf(qx[i][e + 1], x[e + 1], s1);
      }
      s[i][c] = s0 + s1;
    }
  }
#pragma unroll
  for (int o = 1; o < R; o <<= 1)
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (!EDGE || c < n) s[i][c] += __shfl_xor_sync(0xffffffffu, s[i][c], o);
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (EDGE && (c >= n || kp + c > qp + i * (32 / R))) s[i][c] = NEG_INF;  // k after q
    const float mx = fmaxf(m[i], max_of<C>(s[i]));
    const float corr = ex2(m[i] - mx);
    m[i] = mx;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[i][e] *= corr;  // the step's correction
#pragma unroll
    for (int c = 0; c < C; ++c)  // s becomes p (0 where masked, also while m is NEG_INF)
      s[i][c] = EDGE && s[i][c] == NEG_INF ? 0.f : ex2(s[i][c] - mx);
    l[i] = fmaf(l[i], corr, sum_of<C>(s[i]));
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float y[DL];
    if (EDGE && c >= n) continue;
    lds16(y, V + c * D, j);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[i][e] = fmaf(s[i][c], y[e], acc[i][e]);
  }
}

// The S groups' partial softmax states of the block's rows (m, l and acc,
// M rows a thread), merged into group 0's through shared memory `smem`
// once every group is done with it: m becomes the max over the groups,
// and each group's l and acc, scaled by exp2(m_g - m), are added in group
// order (the same bits every run). Returns whether this thread holds the
// merged state (group 0).
template <int S, int M>
__device__ __forceinline__ bool merge_groups(float4* smem, float (*acc)[DL], float* m, float* l) {
  if constexpr (S == 1) {
    return true;
  } else {
    constexpr int GT = NT_F32 / S;         // threads a group
    constexpr int F = M * DL / 4 + M / 2;  // float4s a thread: acc, then (m, l) of row pairs
    const int t = threadIdx.x % GT, g = threadIdx.x / GT;
    cp_wait<0>();
    __syncthreads();
    if (g > 0) {  // [S - 1][F][GT]: neighbouring threads, neighbouring float4s
      float4* x = smem + (g - 1) * F * GT + t;
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int c = 0; c < DL / 4; ++c)
          x[(i * DL / 4 + c) * GT] = make_float4(acc[i][4 * c], acc[i][4 * c + 1],
                                                 acc[i][4 * c + 2], acc[i][4 * c + 3]);
#pragma unroll
      for (int i = 0; i < M; i += 2)
        x[(M * DL / 4 + i / 2) * GT] = make_float4(m[i], l[i], m[i + 1], l[i + 1]);
    }
    __syncthreads();
    if (g > 0) return false;
    float mx[M];
#pragma unroll
    for (int i = 0; i < M; ++i) mx[i] = m[i];
#pragma unroll 1
    for (int gp = 1; gp < S; ++gp)
#pragma unroll
      for (int i = 0; i < M; i += 2) {
        const float4 z = smem[((gp - 1) * F + M * DL / 4 + i / 2) * GT + t];
        mx[i] = fmaxf(mx[i], z.x);
        mx[i + 1] = fmaxf(mx[i + 1], z.z);
      }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float a = ex2(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= a;
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[i][e] *= a;
    }
#pragma unroll 1
    for (int p = 1; p < S; ++p) {
      const float4* x = smem + (p - 1) * F * GT + t;
      float a[M];
#pragma unroll
      for (int i = 0; i < M; i += 2) {
        const float4 z = x[(M * DL / 4 + i / 2) * GT];
        a[i] = ex2(z.x - mx[i]);
        a[i + 1] = ex2(z.z - mx[i + 1]);
        l[i] = fmaf(z.y, a[i], l[i]);
        l[i + 1] = fmaf(z.w, a[i + 1], l[i + 1]);
      }
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int c = 0; c < DL / 4; ++c) {
          const float4 w = x[(i * DL / 4 + c) * GT];
          float* d = &acc[i][4 * c];
          d[0] = fmaf(w.x, a[i], d[0]);
          d[1] = fmaf(w.y, a[i], d[1]);
          d[2] = fmaf(w.z, a[i], d[2]);
          d[3] = fmaf(w.w, a[i], d[3]);
        }
    }
    return true;
  }
}

// Forward, float32; replaces `_fa_kernel` (elasticdl_tpu/ops/flash_attention.py:79).
// Bound by the products on the CUDA cores (two D-long products per visible
// (q, k) pair at 67 TFLOP/s; the one exp2 per pair comes second in f32).
// Each thread holds 16 dims of MR q rows (`fc<D>`) with their o
// accumulators, m and l (base 2) in registers and walks the k rows they
// see by steps of C (`fwd_step`): every row group of a warp reads the
// same k and v row of the streamed tile (a broadcast), and p stays in
// registers. k/v tiles arrive by cp.async STAGES - 1 tiles ahead, with one
// barrier a tile; the S groups of a block take a share of every tile's k
// rows each and merge their partial (m, l, acc) in group order at the end
// (no atomics). o = acc / l, and lse = (m + log2 l) ln 2, natural as the
// backward kernels read it. grid (B*H, row_blocks): a causal block takes
// q tiles y and n - 1 - y. Only the steps that reach past a warp's first q
// row compare positions.
template <int D>
__global__ void __launch_bounds__(NT_F32, 2) fa_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int L, int H, int causal, float scale) {
  constexpr Fc F = fc<D>();
  constexpr int M = F.MR, S = F.S, TS = F.TS, STAGES = F.STAGES, C = F.C, R = D / DL;
  constexpr int RW = 32 * M / R, GT = NT_F32 / S, RB = fwd_rows<D>(), TILE = TS * D;
  static_assert(GT % 32 == 0 && M % 2 == 0 && TS % S == 0 && T64 % TS == 0 &&
                    T64 % RB == 0 && TS / S % C == 0,
                "groups of whole warps, pairs of rows, tiles that divide 64 rows, whole steps");
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // STAGES x (k tile, v tile)
  const int bh = blockIdx.x, b = bh / H, h = bh % H, n_rb = L / RB, y = blockIdx.y;
  const int t = threadIdx.x % GT, g = threadIdx.x / GT, lane = t % 32, j = lane % R;
  const float sl2 = scale * LOG2E;
  const int items = causal && 2 * y + 1 < n_rb ? 2 : 1;

  for (int item = 0; item < items; ++item) {
    const int q0 = (item == 1 ? n_rb - 1 - y : y) * RB;
    const int w0 = q0 + t / 32 * RW, wl = w0 + RW - 1;  // this warp's first and last q rows
    const int row0 = w0 + lane / R;  // this thread's q rows: row0 + i * 32 / R
    const int n_t = causal ? (q0 + RB - 1) / TS + 1 : L / TS;
    if (item > 0) {
      cp_wait<0>();
      __syncthreads();  // the last row tile is done with the ring and the merge
    }
    auto load_stage = [&](int st, int kt) {
      cp_tile_f32<D, TS>(ring + st * 2 * TILE, k, b, h, kt * TS, L, H);
      cp_tile_f32<D, TS>(ring + st * 2 * TILE + TILE, v, b, h, kt * TS, L, H);
    };
    // k/v tiles 0 .. STAGES-2 in flight, one commit group each
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < n_t) load_stage(i, i);
      cp_commit();
    }

    float qx[M][DL], acc[M][DL], m[M], l[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      ldg16(qx[i], q + gidx<D>(b, row0 + i * (32 / R), h, DL * j, L, H));
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        qx[i][e] *= sl2;
        acc[i][e] = 0.f;
      }
      m[i] = NEG_INF;
      l[i] = 0.f;
    }

    for (int kt = 0; kt < n_t; ++kt) {
      const int st = kt % STAGES, k0 = kt * TS;
      cp_wait<STAGES - 2>();  // tile kt has landed (this thread's copies)
      __syncthreads();        // ... everyone's, and the stage read at kt-1 is free
      const int nt = kt + STAGES - 1;
      if (nt < n_t) load_stage(nt % STAGES, nt);
      cp_commit();  // possibly empty, so that every iteration commits one group
      const float* Kt = ring + st * 2 * TILE;
      const float* Vt = Kt + TILE;
      // this group's k rows of the tile, [ra, rb); when causal, rows after
      // the warp's last q row add nothing to it and rows up to its first
      // need no compare
      const int ra = g * (TS / S);
      int rb = ra + TS / S, rm = rb;
      if (causal) {
        rb = min(rb, wl + 1 - k0);
        rm = max(ra, min(rb, w0 + 1 - k0));
      }
      for (int r0 = ra; r0 < rb; r0 += C) {
        if (r0 + C <= rm)
          fwd_step<R, M, C, false>(qx, acc, m, l, Kt + r0 * D, Vt + r0 * D, j, C, 0, 0);
        else
          fwd_step<R, M, C, true>(qx, acc, m, l, Kt + r0 * D, Vt + r0 * D, j, rb - r0, k0 + r0,
                                  row0);
      }
    }

    if (merge_groups<S, M>(smem4, acc, m, l))
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const int r = row0 + i * (32 / R);
        stg16(o + gidx<D>(b, r, h, DL * j, L, H), acc[i], 1.f / l[i]);
        if (j == 0) lse[(size_t)bh * L + r] = (m[i] + log2f(l[i])) * LN2;
      }
  }
}

bool bad_shape(int B, int L, int H, int Dh) {
  return (Dh != 16 && Dh != 32 && Dh != 64 && Dh != 128) || L <= 0 || L % T64 != 0 || B <= 0 ||
         H <= 0 || (long)B * H > 65535;
}

// Dynamic shared memory of each kernel at head dim D (bytes)
// the f32 forward: the ring of k and v tiles, or the S - 1 groups' partial
// states if larger (24, 48, 96, 64 KB at D = 16, 32, 64, 128)
template <int D>
size_t smem_fwd_f32() {
  constexpr Fc F = fc<D>();
  const size_t ring = (size_t)F.STAGES * 2 * F.TS * D;
  const size_t states = (size_t)(F.S - 1) * (NT_F32 / F.S) * F.MR * (DL + 2);
  return sizeof(float) * (ring > states ? ring : states);
}
// the f32 backward kernel W (1 dq, 2 dk+dv): the ring of two streamed
// tiles (and dk+dv's lse and delta rows) a stage, or the S - 1 groups'
// partial sums if larger (dq: 24, 48, 96, 64 KB at D = 16, 32, 64, 128;
// dk+dv: 25.5, 49.5, 65, 64.5 KB)
template <int D, int W>
size_t smem_bwd_f32() {
  constexpr Cc C = cc<D, W>();
  const size_t ring = (size_t)C.STAGES * (2 * C.TS * D + (W == 2 ? 2 * C.TS : 0));
  const size_t sums = (size_t)(C.S - 1) * rows_of<D, W>() * D * W;
  return sizeof(float) * (ring > sums ? ring : sums);
}
template <int D>
size_t smem_fwd_bf16() {  // q rows and the k/v stages (D = 16: 12 KB, 32: 24, 64: 64, 128: 80)
  return (Tc<D>::FWD_MT + 2 * Tc<D>::STAGES) * T64 * D * sizeof(bf16);
}
template <int D>
size_t smem_dq_bf16() {  // q and do tiles and the k/v stages (12, 24, 64, 96 KB)
  return (2 + 2 * Tc<D>::STAGES) * T64 * D * sizeof(bf16);
}
template <int D>
size_t smem_dkv_bf16() {  // k and v tiles, the q/do stages and their lse/delta rows (13, 25, 65.5, 97 KB)
  return (2 + 2 * Tc<D>::STAGES) * T64 * D * sizeof(bf16) + Tc<D>::STAGES * 2 * T64 * sizeof(float);
}

// Each kernel's launch by head dim and dtype (which: 0 forward, 1 dq, 2
// dk+dv): its function, grid, threads and dynamic shared memory. The
// launches and the occupancy query both read it. Every kernel takes the
// head first, grid (B*H, row tiles): the float32 ones RB rows a block
// (`fc<D>`, `cc<D, W>`; a causal block two row tiles, `row_blocks`), the
// bfloat16 ones 64 (the forward 64 FWD_MT).
struct Launch {
  const void* fn;
  dim3 grid;
  int threads;
  size_t smem;
};

template <int D>
Launch launch_of(int which, int dtype, int B, int L, int H, int causal) {
  const dim3 heads(B * H, L / T64);
  if (dtype == 0) {
    if (which == 0)
      return {(const void*)fa_fwd_kernel<D>, dim3(B * H, row_blocks(L / fwd_rows<D>(), causal)),
              NT_F32, smem_fwd_f32<D>()};
    if (which == 1)
      return {(const void*)fa_dq_kernel<D>,
              dim3(B * H, row_blocks(L / rows_of<D, 1>(), causal)),
              NT_F32, smem_bwd_f32<D, 1>()};
    return {(const void*)fa_dkv_kernel<D>,
            dim3(B * H, row_blocks(L / rows_of<D, 2>(), causal)),
            NT_F32, smem_bwd_f32<D, 2>()};
  }
  if (which == 0) {
    const int bm = T64 * Tc<D>::FWD_MT;
    return {(const void*)fa_fwd_bf16_kernel<D>, dim3(B * H, (L + bm - 1) / bm), NT_TC,
            smem_fwd_bf16<D>()};
  }
  if (which == 1) return {(const void*)fa_dq_bf16_kernel<D>, heads, NT_TC, smem_dq_bf16<D>()};
  return {(const void*)fa_dkv_bf16_kernel<D>, heads, NT_TC, smem_dkv_bf16<D>()};
}

Launch launch_of(int which, int Dh, int dtype, int B, int L, int H, int causal) {
  switch (Dh) {
    case 16: return launch_of<16>(which, dtype, B, L, H, causal);
    case 32: return launch_of<32>(which, dtype, B, L, H, causal);
    case 64: return launch_of<64>(which, dtype, B, L, H, causal);
    default: return launch_of<128>(which, dtype, B, L, H, causal);  // bad_shape took every other
  }
}

// cudaFuncSetAttribute for the dynamic shared memory, then the launch of
// kernel `which` with the kernel's arguments `args`; returns the
// cudaError_t
int launch(int which, int B, int L, int H, int Dh, int causal, int dtype, void** args,
           void* stream) {
  if (bad_shape(B, L, H, Dh) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const Launch k = launch_of(which, Dh, dtype, B, L, H, causal);
  cudaError_t e = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)k.smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaLaunchKernel(k.fn, k.grid, dim3(k.threads), args, k.smem,
                               static_cast<cudaStream_t>(stream));
}

}  // namespace

// C entry points. dtype: 0 = float32, 1 = bfloat16; the dtype picks the
// design (the CUDA-core kernel for float32, the tensor-core kernel for
// bfloat16) and Dh (16, 32, 64 or 128) its instantiation. Each returns the
// cudaError_t of the launch (0 on success); the kernel runs on `stream`.
// The pointers are passed on as the kernel's float or bf16 pointers.
extern "C" {

int edl_fa_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int L,
               int H, int Dh, int causal, float scale, int dtype, void* stream) {
  void* args[] = {&q, &k, &v, &o, &lse, &L, &H, &causal, &scale};
  return launch(0, B, L, H, Dh, causal, dtype, args, stream);
}

int edl_fa_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int L, int H, int Dh, int causal, float scale,
              int dtype, void* stream) {
  void* args[] = {&q, &k, &v, &dout, &lse, &delta, &dq, &L, &H, &causal, &scale};
  return launch(1, B, L, H, Dh, causal, dtype, args, stream);
}

int edl_fa_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int L, int H, int Dh, int causal,
               float scale, int dtype, void* stream) {
  void* args[] = {&q, &k, &v, &dout, &lse, &delta, &dk, &dv, &L, &H, &causal, &scale};
  return launch(2, B, L, H, Dh, causal, dtype, args, stream);
}

// Blocks an SM holds of kernel `which` (0 forward, 1 dq, 2 dk+dv) at
// head dim Dh and dtype, by the occupancy calculator (registers, shared
// memory and threads together); a negative value is a cudaError_t
int edl_fa_blocks_per_sm(int which, int Dh, int dtype) {
  if (bad_shape(1, T64, 1, Dh) || (dtype != 0 && dtype != 1)) return -(int)cudaErrorInvalidValue;
  const Launch k = launch_of(which, Dh, dtype, 1, T64, 1, 1);
  cudaError_t e = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)k.smem);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k.fn, k.threads,
                                                                          k.smem);
  return e == cudaSuccess ? n : -(int)e;
}

}  // extern "C"

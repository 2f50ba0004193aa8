// Forward flash attention (online softmax over kv blocks) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` in src/repro/kernels/flash_attention.py
// (reached through `repro.kernels.ops.flash_attention`).  For q (BH, S, D) and
// k, v (BH, Sk, D), one dtype T of f32, bf16 and fp16, scale = 1/sqrt(D), and
// the kv axis in blocks of BK (the reference's block_k) keys:
//
//     s   = (sum_d q[i,d] k[j,d], in f32) * scale     keys >= Sk, and with
//           `causal` keys j > i, masked to -1e30 (positions from 0 for both)
//     m'  = max(m, max over the block of s)            p = exp(s - m')
//     a   = exp(m - m')                                l = l * a + sum_j p
//     acc = acc * a + sum_j round_T(p) v[j]            (f32 sums)
//     out = acc / max(l, 1e-30), rounded to T
//
// as the reference's kernel computes it: the scale applied after the dot,
// m, l and acc in f32, p rounded to v's dtype for p.v while l sums the
// unrounded p, and m' the max over the whole kv block before any p is
// formed (p's rounding depends on the block).  Blocks that causal masks
// entirely are skipped: their p is exactly 0 and a exactly 1.  No atomics:
// a rerun is bit-identical.
//
// What bounds it.  Causal at S = Sk, 4 * BH * D * S(S+1)/2 flops (q.k and
// p.v): at the smollm-360m shape (BH = 15, S = 32768, D = 64) 2.06 TFLOP,
// 2.1 ms on the tensor cores at 989 TFLOP/s in bf16, 31 ms at the CUDA
// cores' 67 TFLOP/s in f32; its bytes (q, k, v, out: 252 MB in bf16) take
// 75 us.  Bound by operations.
//
// Half modes (bf16, fp16): the tensor cores, FlashAttention-2 style.  A
// product of two halves is exact in f32, so `mma.sync.m16n8k16` with f32
// accumulators computes what the reference's dots at
// preferred_element_type=f32 compute, up to the order of the sums.
//  * A block of NW warps (4 at D <= 64, 8 at D = 128) takes 16 * NW queries
//    of one batch-head, the tiles with the most causal work first; a warp
//    owns 16 query rows and keeps their Q fragments in registers for the
//    whole kv loop (read once from global memory).
//  * K and V stay in shared memory in their own dtype, staged by cp.async
//    (16 B a thread) in a ring of two kv blocks: the next block's copy is in
//    flight while this block's products run.  Rows are padded by 16 B, so
//    `ldmatrix` (`.trans` for V) reads them without bank conflicts; rows
//    past Sk and the pad rows of a block that is not a multiple of 16 are
//    zero-filled by the copy.
//  * A warp keeps the whole kv block's s in registers (16 x BK f32, BK/2 a
//    thread), so m' is the block's max: a thread's max, then the row's quad
//    by `__shfl_xor_sync`.  p = expf(s - m') is summed into l unrounded,
//    rounded to T and packed straight from the accumulator layout into the
//    A fragments of the p.v `mma`: p never goes through shared memory.  A
//    block of BK not a multiple of 16 pads its last k16 step with p = 0 and
//    zero V rows, which is exact.
//  * Each block's p.v goes into a fresh f32 sum (4 n8 tiles of the head
//    dim at a time), folded as acc = acc * a + pv with round-to-nearest f32
//    operations, as the reference does: the tensor cores' f32 accumulation
//    does not round to nearest, and one accumulator carried through
//    hundreds of kv blocks drifts past the fp16 yardstick at 32k.
//  * Only the warps whose rows cross the diagonal or Sk mask; a warp whose
//    rows causal masks entirely in a kv block skips it.
//  What holds it above its bound: every warp reads the whole K and V block
//  through ldmatrix for its own 16 rows (32 KB a kv block at D 64), and that
//  shared-memory traffic, the mma.sync rate and the softmax's ALU work
//  (expf) overlap little.
// f32 mode: the CUDA cores (TF32 would round the operands, and the f32 check
// is 1e-5 relative): f32 FMAs with the tiles in shared memory as f32, one
// block of 256 threads per (64-query tile, batch-head).  Per kv block: K^T
// [D][BK] and V [BK][D] are staged; each thread computes a 4 x 8 tile of s
// (float4 broadcasts of Q^T and K^T, 32 FMAs per three loads), masks and
// stores it transposed; 4 threads per query row take the row's max, p and
// the sum of p over a quarter of the block each, combined in a fixed order;
// then each thread adds p.v into a 4 x (D/16) register tile of its own and
// folds it into acc as acc * a + p.v.
//
// Registers (`-Xptxas -v`, sm_90a), no spills anywhere: the half-mode kernel
// at block_k 128 takes 143 / 168 / 255 registers at D 32 / 64 / 128 (4, 3
// and 1 blocks an SM), 163 / 187 / 237 at other kv blocks; the f32-mode
// kernel 71 / 79 / 121.
//
// Tried on an H100 and not kept: `wgmma` (m64nNk16, Q and p from registers,
// K and V as no-swizzle core-matrix tiles) reads K and V once per 64 rows,
// but with each product group waiting on its result it ran slower than this
// kernel; 8 warps a block at D 64, and `__expf` in place of `expf`
// (`tools/kernel_trials.py` times both beside this kernel).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_sync.cuh"

namespace {

constexpr int NT = 256;          // threads per block (f32 mode)
constexpr int BQ = 64;           // queries per block (f32 mode)
constexpr int BKMAX = 128;       // the largest kv block
constexpr int QP = BQ + 4;       // padded row of Q^T and P^T
constexpr int KP = BKMAX + 4;    // padded row of K^T
constexpr int SMEM_MAX = 232448;  // 227 KB, the most a block may opt in to
constexpr float NEG_INF = -1e30f;

enum { FMT_F32 = 0, FMT_BF16 = 1, FMT_F16 = 2 };

template <int FMT>
struct Fmt;

template <>
struct Fmt<FMT_F32> {
  using T = float;
  __device__ static float ld(T v) { return v; }
  __device__ static T st(float v) { return v; }
};

template <>
struct Fmt<FMT_BF16> {
  using T = __nv_bfloat16;
};

template <>
struct Fmt<FMT_F16> {
  using T = __half;
};

using namespace mma_sync;

// ---------------------------------------------------------------------------
// f32 mode: the CUDA-core kernel
// ---------------------------------------------------------------------------
long long smem_floats(int D) {
  // Q^T [D][QP], K^T [D][KP], V [BKMAX][D], P^T [BKMAX][QP], m, l and a
  // [BQ], and the max and sum partials [4][BQ] each
  return static_cast<long long>(D) * QP + static_cast<long long>(D) * KP +
         static_cast<long long>(BKMAX) * D + static_cast<long long>(BKMAX) * QP + 3 * BQ +
         8 * BQ;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int S, int Sk,
                 int BK, int causal, float scale) {
  using F = Fmt<FMT_F32>;
  constexpr int DC = D / 16;     // p.v columns per thread
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;              // Q^T, [D][QP]
  float* sk = sq + D * QP;       // K^T, [D][KP]
  float* sv = sk + D * KP;       // V, [BKMAX][D]
  float* sp = sv + BKMAX * D;    // s, then round_T(p), transposed: [BKMAX][QP]
  float* sm = sp + BKMAX * QP;   // m, [BQ]
  float* sl = sm + BQ;           // l, [BQ]
  float* sa = sl + BQ;           // a, [BQ]
  float* smax = sa + BQ;         // per-quarter row max, [4][BQ]
  float* ssum = smax + 4 * BQ;   // per-quarter sum of p, [4][BQ]

  const int tid = threadIdx.x;
  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const size_t bh = blockIdx.y;
  const typename F::T* qb = q + bh * S * D;
  const typename F::T* kb = k + bh * Sk * D;
  const typename F::T* vb = v + bh * Sk * D;

  for (int t = tid; t < BQ * D; t += NT) {
    const int r = t / D, d = t % D;
    sq[d * QP + r] = q0 + r < S ? F::ld(qb[static_cast<size_t>(q0 + r) * D + d]) : 0.f;
  }
  if (tid < BQ) {
    sm[tid] = NEG_INF;
    sl[tid] = 0.f;
  }

  // the s tile: rows 4*ra.., keys 8*ka..; the p.v tile: rows 4*ra.., columns DC*ka..
  const int ra = tid / 16, ka = tid % 16;
  // the row pass: row rr, keys 32*qt..32*qt+31 of the block
  const int rr = tid % BQ, qt = tid / BQ;
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int nkb = (Sk + BK - 1) / BK;
  if (causal) nkb = min(nkb, (q0 + BQ - 1) / BK + 1);
  for (int blk = 0; blk < nkb; ++blk) {
    const int k0 = blk * BK;
    __syncthreads();   // the previous block's tiles are read
    for (int t = tid; t < BK * D; t += NT) {
      const int j = t / D, d = t % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + j < Sk) {
        const size_t off = static_cast<size_t>(k0 + j) * D + d;
        kv = F::ld(kb[off]);
        vv = F::ld(vb[off]);
      }
      sk[d * KP + j] = kv;
      sv[j * D + d] = vv;
    }
    __syncthreads();

    if (8 * ka < BK) {
      float s[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      }
      for (int d = 0; d < D; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(sq + d * QP + 4 * ra);
        const float4 b0 = *reinterpret_cast<const float4*>(sk + d * KP + 8 * ka);
        const float4 b1 = *reinterpret_cast<const float4*>(sk + d * KP + 8 * ka + 4);
        const float qa[4] = {a.x, a.y, a.z, a.w};
        const float kk[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + 8 * ka + j;
        float val[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q0 + 4 * ra + i;
          const bool masked = key >= Sk || (causal && row < key);
          val[i] = masked ? NEG_INF : __fmul_rn(s[i][j], scale);
        }
        *reinterpret_cast<float4*>(sp + (8 * ka + j) * QP + 4 * ra) =
            make_float4(val[0], val[1], val[2], val[3]);
      }
    }
    __syncthreads();

    // the row max over the whole block, then p, its rounding and its sum
    const int jlo = 32 * qt, jhi = min(BK, jlo + 32);
    float mx = NEG_INF;
    for (int j = jlo; j < jhi; ++j) mx = fmaxf(mx, sp[j * QP + rr]);
    smax[qt * BQ + rr] = mx;
    __syncthreads();
    const float m_prev = sm[rr];
    const float m_new = fmaxf(m_prev, fmaxf(fmaxf(smax[rr], smax[BQ + rr]),
                                            fmaxf(smax[2 * BQ + rr], smax[3 * BQ + rr])));
    float ls = 0.f;
    for (int j = jlo; j < jhi; ++j) {
      const float p = expf(sp[j * QP + rr] - m_new);
      ls += p;
      sp[j * QP + rr] = F::ld(F::st(p));
    }
    ssum[qt * BQ + rr] = ls;
    __syncthreads();
    if (qt == 0) {
      const float a = expf(m_prev - m_new);
      const float psum = (ssum[rr] + ssum[BQ + rr]) + (ssum[2 * BQ + rr] + ssum[3 * BQ + rr]);
      sl[rr] = __fadd_rn(__fmul_rn(sl[rr], a), psum);
      sm[rr] = m_new;
      sa[rr] = a;
    }
    __syncthreads();

    // acc = acc * a + round_T(p) . v
    float pv[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < DC; ++c) pv[i][c] = 0.f;
    }
    for (int j = 0; j < BK; ++j) {
      const float4 pr = *reinterpret_cast<const float4*>(sp + j * QP + 4 * ra);
      const float pp[4] = {pr.x, pr.y, pr.z, pr.w};
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sv[j * D + DC * ka + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < DC; ++c) pv[i][c] = fmaf(pp[i], vv[c], pv[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sa[4 * ra + i];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] = __fadd_rn(__fmul_rn(acc[i][c], a), pv[i][c]);
    }
  }

  // out = acc / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ra + i;
    if (row >= S) continue;
    const float denom = fmaxf(sl[4 * ra + i], 1e-30f);
    typename F::T* o = out + (bh * S + row) * D + DC * ka;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[c] = F::st(acc[i][c] / denom);
  }
}

// ---------------------------------------------------------------------------
// Half modes: the tensor-core kernel.  Warps per block and padded row (in
// elements) of the staged K and V.
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int half_warps(int D) { return D > 64 ? 8 : 4; }

__host__ __device__ constexpr int half_pitch(int D) { return D + 8; }

__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

// the ring: two kv blocks of K and V, BK rounded up to 16 rows each
size_t half_smem_bytes(int D, int BK) {
  return 2 * 2 * static_cast<size_t>(pad16(BK)) * half_pitch(D) * 2;
}

template <int FMT, int D, bool FULL>
__global__ void __launch_bounds__(half_warps(D) * 32)
flash_fwd_mma_kernel(const typename Fmt<FMT>::T* __restrict__ q,
                     const typename Fmt<FMT>::T* __restrict__ k,
                     const typename Fmt<FMT>::T* __restrict__ v,
                     typename Fmt<FMT>::T* __restrict__ out, int S, int Sk, int BK,
                     int causal, float scale) {
  using T = typename Fmt<FMT>::T;
  constexpr int NW = half_warps(D);
  constexpr int NTH = 32 * NW;
  constexpr int BQH = 16 * NW;          // queries per block
  constexpr int DP = half_pitch(D);
  constexpr int KD = D / 16;            // k16 steps of q.k^T
  constexpr int DN = D / 8;             // n8 tiles of p.v
  constexpr int PVN = 4;                // of which one p.v sum takes at a time
  constexpr int NTILE = BKMAX / 8;      // n8 tiles of s at most
  constexpr int CPR = D / 8;            // 16-byte chunks in a row of K or V
  const int nt = FULL ? NTILE : BK / 8;  // n8 tiles of s in this block size
  const int BK16 = FULL ? BKMAX : pad16(BK);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);
  const int stage = 2 * BK16 * DP;      // elements of one kv block, K then V

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int nq = (S + BQH - 1) / BQH;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQH;
  const int qw = q0 + 16 * warp;        // this warp's first query row
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * S * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;

  int nkb = (Sk + BK - 1) / BK;
  if (causal) nkb = min(nkb, (q0 + BQH - 1) / BK + 1);

  // stage kv block `blk` into ring slot blk % 2 (one commit group either way)
  auto stage_kv = [&](int blk) {
    if (blk < nkb) {
      T* sk = ring + (blk & 1) * stage;
      T* sv = sk + BK16 * DP;
      const int k0 = blk * BK;
      for (int e = tid; e < BK16 * CPR; e += NTH) {
        const int r = e / CPR, c = e % CPR;
        const bool ok = r < BK && k0 + r < Sk;
        const size_t off = ok ? static_cast<size_t>(k0 + r) * D + 8 * c : 0;
        cp_async16(smem_addr(sk + r * DP + 8 * c), kb + off, ok ? 16 : 0);
        cp_async16(smem_addr(sv + r * DP + 8 * c), vb + off, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  stage_kv(0);
  stage_kv(1);

  // Q's A fragments, rows qw + g and qw + g + 8, zero past S
  uint32_t qa[KD][4];
  {
    const int r0 = qw + g, r1 = r0 + 8;
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      const int d = 16 * c + 2 * t4;
      qa[c][0] = r0 < S ? *reinterpret_cast<const uint32_t*>(qb + static_cast<size_t>(r0) * D + d) : 0u;
      qa[c][1] = r1 < S ? *reinterpret_cast<const uint32_t*>(qb + static_cast<size_t>(r1) * D + d) : 0u;
      qa[c][2] = r0 < S ? *reinterpret_cast<const uint32_t*>(qb + static_cast<size_t>(r0) * D + d + 8) : 0u;
      qa[c][3] = r1 < S ? *reinterpret_cast<const uint32_t*>(qb + static_cast<size_t>(r1) * D + d + 8) : 0u;
    }
  }

  float m_row[2] = {NEG_INF, NEG_INF}, l_row[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  for (int blk = 0; blk < nkb; ++blk) {
    cp_async_wait<1>();   // this block's copy has landed (the next may be in flight)
    __syncthreads();
    const T* sk = ring + (blk & 1) * stage;
    const T* sv = sk + BK16 * DP;
    const int k0 = blk * BK;
    if (qw < S && (!causal || k0 <= qw + 15)) {
      // s = q.k^T over the whole kv block
      float s[NTILE][4];
#pragma unroll
      for (int j = 0; j < NTILE; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < KD; ++c) {
#pragma unroll
        for (int j = 0; j < NTILE; j += 2) {
          if (j < nt) {
            // matrices: tile j at d 16c / 16c + 8, then tile j + 1
            uint32_t b[4];
            ldsm_x4(b, smem_addr(sk + (8 * (j + (lane >> 4)) + (lane & 7)) * DP + 16 * c +
                                 8 * ((lane >> 3) & 1)));
            mma16816<T>(s[j], qa[c], b[0], b[1]);
            if (j + 1 < nt) mma16816<T>(s[j + 1], qa[c], b[2], b[3]);
          }
        }
      }
      // scale after the dot; mask only where the block crosses Sk or the diagonal
      const bool masking = k0 + BK > Sk || (causal && k0 + BK - 1 > qw);
      float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
      for (int j = 0; j < NTILE; ++j) {
        if (j < nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = __fmul_rn(s[j][e], scale);
            if (masking) {
              const int key = k0 + 8 * j + 2 * t4 + (e & 1);
              const int row = qw + g + 8 * (e >> 1);
              if (key >= Sk || (causal && key > row)) x = NEG_INF;
            }
            s[j][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
      }
      // m' over the row's quad; a = exp(m - m')
      float a[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        a[h] = expf(m_row[h] - mx[h]);
      }
      // p = exp(s - m'): summed unrounded, rounded to T into p.v's A fragments
      uint32_t pa[NTILE / 2][4];
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NTILE; ++j) {
        if (j < nt) {
          const float p0 = expf(s[j][0] - mx[0]), p1 = expf(s[j][1] - mx[0]);
          const float p2 = expf(s[j][2] - mx[1]), p3 = expf(s[j][3] - mx[1]);
          ps[0] += p0;
          ps[0] += p1;
          ps[1] += p2;
          ps[1] += p3;
          pa[j >> 1][2 * (j & 1)] = pack2<T>(p0, p1);
          pa[j >> 1][2 * (j & 1) + 1] = pack2<T>(p2, p3);
        } else if (j == nt && (j & 1)) {   // the pad half of the last k16 step
          pa[j >> 1][2] = 0u;
          pa[j >> 1][3] = 0u;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
        ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
        l_row[h] = __fadd_rn(__fmul_rn(l_row[h], a[h]), ps[h]);
        m_row[h] = mx[h];
      }
      // pv = round_T(p) . v over this block's keys in a fresh f32 sum, then
      // acc = acc * a + pv, PVN n8 tiles of the head dim at a time
#pragma unroll
      for (int n0 = 0; n0 < DN; n0 += PVN) {
        float pv[PVN][4];
#pragma unroll
        for (int n = 0; n < PVN; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
        }
#pragma unroll
        for (int kc = 0; kc < NTILE / 2; ++kc) {
          if (2 * kc < nt) {
#pragma unroll
            for (int n = 0; n < PVN; n += 2) {
              // matrices: keys 16kc / 16kc + 8 at d 8(n0 + n), then at d 8(n0 + n + 1)
              uint32_t b[4];
              ldsm_x4_trans(b, smem_addr(sv + (16 * kc + 8 * ((lane >> 3) & 1) + (lane & 7)) * DP +
                                         8 * (n0 + n + (lane >> 4))));
              mma16816<T>(pv[n], pa[kc], b[0], b[1]);
              mma16816<T>(pv[n + 1], pa[kc], b[2], b[3]);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < PVN; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[n0 + n][e] = __fadd_rn(__fmul_rn(acc[n0 + n][e], a[e >> 1]), pv[n][e]);
          }
        }
      }
    }
    __syncthreads();      // every warp is done with this slot
    stage_kv(blk + 2);
  }
  cp_async_wait<0>();

  // out = acc / max(l, 1e-30), two columns a store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qw + g + 8 * h;
    if (row >= S) continue;
    const float denom = fmaxf(l_row[h], 1e-30f);
    T* o = out + (bh * S + row) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      *reinterpret_cast<uint32_t*>(o + 8 * n) =
          pack2<T>(acc[n][2 * h] / denom, acc[n][2 * h + 1] / denom);
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int BH, int S, int Sk,
               int BK, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(D) * sizeof(float);
  if (smem > SMEM_MAX) return -2;
  // opt in to more than 48 KB of dynamic shared memory once, at the first
  // launch (never inside a CUDA graph capture, which follows a warm-up)
  static const cudaError_t opted = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const dim3 grid((S + BQ - 1) / BQ, BH, 1);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, Sk, BK, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int FMT, int D, bool FULL>
cudaError_t opt_in_half() {
  auto* kernel = flash_fwd_mma_kernel<FMT, D, FULL>;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        SMEM_MAX);
  if (rc != cudaSuccess) return rc;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int FMT, int D>
int launch_half(const void* q, const void* k, const void* v, void* out, int BH, int S,
                int Sk, int BK, int causal, float scale, cudaStream_t stream) {
  using T = typename Fmt<FMT>::T;
  const size_t smem = half_smem_bytes(D, BK);
  if (smem > SMEM_MAX) return -2;
  // opt in once, at the first launch (never inside a CUDA graph capture)
  static const cudaError_t opted[2] = {opt_in_half<FMT, D, false>(),
                                       opt_in_half<FMT, D, true>()};
  if (opted[0] != cudaSuccess) return static_cast<int>(opted[0]);
  if (opted[1] != cudaSuccess) return static_cast<int>(opted[1]);
  constexpr int BQH = 16 * half_warps(D);
  const dim3 grid((S + BQH - 1) / BQH, BH, 1);
  auto* kernel = BK == BKMAX ? flash_fwd_mma_kernel<FMT, D, true>
                             : flash_fwd_mma_kernel<FMT, D, false>;
  kernel<<<grid, 32 * half_warps(D), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, Sk, BK, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int S, int Sk,
           int BK, int causal, int fmt, float scale, cudaStream_t stream) {
  switch (fmt) {
    case FMT_F32:
      return launch_f32<D>(q, k, v, out, BH, S, Sk, BK, causal, scale, stream);
    case FMT_BF16:
      return launch_half<FMT_BF16, D>(q, k, v, out, BH, S, Sk, BK, causal, scale, stream);
    case FMT_F16:
      return launch_half<FMT_F16, D>(q, k, v, out, BH, S, Sk, BK, causal, scale, stream);
  }
  return -1;
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, allocates nothing,
// and returns cudaGetLastError(), -1 for an unknown format code, or -2 for a
// head dim other than 32, 64 and 128 or a kv block that is not a multiple
// of 8 up to 128 (the Python wrapper checks all three first, and that the
// operands are 16-byte aligned).  S, Sk >= 1.

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int BH, int S, int Sk, int D, int block_k, int causal,
                                   int fmt, float scale, void* stream) {
  if (block_k < 8 || block_k > BKMAX || block_k % 8 != 0) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, out, BH, S, Sk, block_k, causal, fmt, scale, s);
    case 64:
      return launch<64>(q, k, v, out, BH, S, Sk, block_k, causal, fmt, scale, s);
    case 128:
      return launch<128>(q, k, v, out, BH, S, Sk, block_k, causal, fmt, scale, s);
  }
  return -2;
}

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
// formed (p's rounding depends on the block).  A product of two bf16 or two
// fp16 values is exact in f32, so f32 FMAs give what the reference's dots at
// preferred_element_type=f32 give, up to the order of the sums.  Blocks that
// causal masks entirely are skipped: their p is exactly 0 and a exactly 1.
//
// What bounds it.  Causal at S = Sk, 4 * BH * D * S(S+1)/2 flops (q.k and
// p.v): at the smollm-360m shape (BH = 15, S = 32768, D = 64) 2.06 TFLOP,
// 2.1 ms on the tensor cores at 989 TFLOP/s in bf16, 31 ms at the CUDA
// cores' 67 TFLOP/s in f32; its bytes (q, k, v, out: 252 MB in bf16) take
// 75 us.  Bound by operations.
//
// What the design does about it, simply: f32 FMAs on the CUDA cores (no
// tensor cores yet, so bf16 and fp16 run at the f32 rate), with the tiles
// in shared memory as f32.  One block of 256 threads per (64-query tile,
// batch-head), the tiles with the most causal work first.  Per kv block: K^T
// [D][BK] and V [BK][D] are staged; each thread computes a 4 x 8 tile of s
// (float4 broadcasts of Q^T and K^T, 32 FMAs per three loads), masks and
// stores it transposed; 4 threads per query row take the row's max, p and
// the sum of p over a quarter of the block each, combined in a fixed order;
// then each thread adds p.v into a 4 x (D/16) register tile of its own and
// folds it into acc as acc * a + p.v.  No atomics: a rerun is bit-identical.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int BQ = 64;           // queries per block
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
  __device__ static float ld(T v) { return __bfloat162float(v); }
  __device__ static T st(float v) { return __float2bfloat16_rn(v); }
};

template <>
struct Fmt<FMT_F16> {
  using T = __half;
  __device__ static float ld(T v) { return __half2float(v); }
  __device__ static T st(float v) { return __float2half_rn(v); }
};

long long smem_floats(int D) {
  // Q^T [D][QP], K^T [D][KP], V [BKMAX][D], P^T [BKMAX][QP], m, l and a
  // [BQ], and the max and sum partials [4][BQ] each
  return static_cast<long long>(D) * QP + static_cast<long long>(D) * KP +
         static_cast<long long>(BKMAX) * D + static_cast<long long>(BKMAX) * QP + 3 * BQ +
         8 * BQ;
}

template <int FMT, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const typename Fmt<FMT>::T* __restrict__ q,
                 const typename Fmt<FMT>::T* __restrict__ k,
                 const typename Fmt<FMT>::T* __restrict__ v,
                 typename Fmt<FMT>::T* __restrict__ out, int S, int Sk, int BK,
                 int causal, float scale) {
  using F = Fmt<FMT>;
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

template <int FMT, int D>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int S, int Sk,
           int BK, int causal, float scale, cudaStream_t stream) {
  using T = typename Fmt<FMT>::T;
  const size_t smem = smem_floats(D) * sizeof(float);
  if (smem > SMEM_MAX) return -2;
  // opt in to more than 48 KB of dynamic shared memory once, at the first
  // launch (never inside a CUDA graph capture, which follows a warm-up)
  static const cudaError_t opted = cudaFuncSetAttribute(
      flash_fwd_kernel<FMT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const dim3 grid((S + BQ - 1) / BQ, BH, 1);
  flash_fwd_kernel<FMT, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, Sk, BK, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int FMT>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int BH, int S,
               int Sk, int D, int BK, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<FMT, 32>(q, k, v, out, BH, S, Sk, BK, causal, scale, stream);
    case 64:
      return launch<FMT, 64>(q, k, v, out, BH, S, Sk, BK, causal, scale, stream);
    case 128:
      return launch<FMT, 128>(q, k, v, out, BH, S, Sk, BK, causal, scale, stream);
  }
  return -2;
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, allocates nothing,
// and returns cudaGetLastError(), -1 for an unknown format code, or -2 for a
// head dim other than 32, 64 and 128 or a kv block that is not a multiple
// of 8 up to 128 (the Python wrapper checks all three first).  S, Sk >= 1.

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int BH, int S, int Sk, int D, int block_k, int causal,
                                   int fmt, float scale, void* stream) {
  if (block_k < 8 || block_k > BKMAX || block_k % 8 != 0) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case FMT_F32:
      return dispatch_d<FMT_F32>(q, k, v, out, BH, S, Sk, D, block_k, causal, scale, s);
    case FMT_BF16:
      return dispatch_d<FMT_BF16>(q, k, v, out, BH, S, Sk, D, block_k, causal, scale, s);
    case FMT_F16:
      return dispatch_d<FMT_F16>(q, k, v, out, BH, S, Sk, D, block_k, causal, scale, s);
  }
  return -1;
}

// Order-shared (l-shared) spherical spectral contraction (SFNO), forward and
// both backward kernels, for Hopper (sm_90a).
//
// Replace the TPU kernels `_lshared_fwd_kernel` (ls_fwd),
// `_lshared_bwd_x_kernel` (ls_bwd_x) and `_lshared_bwd_w_kernel` (ls_bwd_w)
// in src/repro/kernels/spectral_contract.py, reached through
// `spectral_contract_lshared_pallas` and its custom VJP `_lshared_op_bwd`.
// The spherical convolution theorem shares the weight over the order m, so
// for every degree l
//
//     out[b,o,l,m] = sum_i x[b,i,l,m] * w[i,o,l]              (ls_fwd)
//     dx[b,i,l,m]  = sum_o g[b,o,l,m] * conj(w[i,o,l])        (ls_bwd_x)
//     dw[i,o,l]    = sum_{b,m} conj(x[b,i,l,m]) * g[b,o,l,m]  (ls_bwd_w)
//
// all complex, in split-real form, x (B, I, L, M), g and out (B, O, L, M),
// w (I, O, L).  Every operand arrives at one dtype T (f32, bf16 or fp16: the
// caller rounded x and w to the site's storage format, and the cotangent g
// comes back at the forward's output dtype).  Each term is summed in f32 as
// four real products (rr - ii, ri + ir); a product of two bf16 or two fp16
// values is exact in f32, so f32 FMAs, or the tensor cores' mma with f32
// accumulators, give what the reference's matmuls at
// preferred_element_type=f32 give, up to the order of the sums.  out, dx and
// dw are stored at T, as `_lshared_op_bwd` stores dx at x's dtype and dw at
// w's dtype.
//
// What bounds them.  At the SFNO_SWE path's shape (B=8, I=O=64, L=M=128)
// each kernel does 8*B*I*O*L*M = 4.29 GFLOP against 69 MB of operands and
// results at bf16 (138 MB at f32).  In a half mode every product is half x
// half with f32 sums, which the tensor cores compute exactly: 4.3 us at
// 989 TFLOP/s, under the 20.7 us the bytes take at 3.35 TB/s, so the bound
// is bytes.  In f32 mode the products need the CUDA cores: 64 us at 67
// TFLOP/s against 41 us of bytes, bound by operations.
//
// What the designs do about it.
//  * ls_fwd and ls_bwd_x are one kernel, ls_mix, simply: f32 FMAs on the
//    CUDA cores (so a half mode runs at the f32 rate, several times its
//    bound), the operands staged in shared memory as f32.  A batched complex
//    GEMM per degree, (B*M x K) times (K x N), K = I and N = O (forward) or
//    K = O and N = I against conj(w) transposed (bwd_x).  The weight's
//    l-slice is strided by L in w, so a small staging kernel first writes w
//    as f32 in (L, K, N) order into a workspace; each ls_mix block (64-order
//    tile, l, b, chunk of NC output channels) then copies its l-slice (32 KB
//    at 64 x 64) and its x (or g) tile into shared memory, KC input channels
//    at a time.  Threads run along m, which is contiguous in x and out, so
//    loads and stores coalesce; a thread keeps 8 output channels of one
//    order in registers, fed by one x load and two float4 broadcasts of the
//    weight per 32 FMAs.
//    Channel tiles: where the whole slice [K][N pad 8] and the tile [K][64]
//    fit in 227 KB (K = N up to 139) one chunk covers both axes.  Otherwise
//    the host (`ls_plan` in kernels/spectral_contract.py) takes output chunks
//    of NC <= 64 channels as a grid axis and input chunks of KC channels,
//    a partial sum waiting in a [NC][64] tile of shared memory between input
//    chunks, so every sum keeps the order of one chunk and a rerun is
//    bit-identical.  No width is refused.
//  * ls_bwd_w, for each degree two real GEMMs over K = 2*B*M terms,
//        dw_r = [xr | xi] . [gr | gi]^T      dw_i = [xr | xi] . [gi | -gr]^T
//    (negating a half is exact), is bound by streaming x and g.  One block
//    of 8 warps per (l, 64 x 64 tile of (i, o)): 128 blocks at the path's
//    shape, one per SM.  A row x[b, i, l, 0:M] is contiguous, so chunks of
//    one batch row and 256 bytes of orders (128 in f32 mode) of xr, xi, gr
//    and gi go straight from x and g into shared memory by 16-byte cp.async
//    (elementwise where M or an operand is not 16-byte aligned), in a ring
//    of 3 stages (4 in f32 mode) that keeps two chunks in flight while one
//    is summed; rows are padded by 16 bytes, so ldmatrix and float2 reads
//    are free of bank conflicts.  The (b, m) sum is split over two groups
//    of 4 warps (the first and second half of each chunk's orders), each
//    warp a 32 x 32 quadrant of the tile; the groups' partial sums are
//    added through shared memory in a fixed order at the end.  Half modes:
//    mma.sync m16n8k16 with f32 accumulators, x as A (ldmatrix) and g as
//    B (ldmatrix), four products per k16 step.  f32 mode: the CUDA cores
//    (store_budget assumes exact products, which TF32 would not give), a
//    4 x 8 complex register tile a thread fed by float2 reads, 24 shared
//    loads per 256 FMAs.  No atomics: a rerun is bit-identical.
//
// Registers of ls_bwd_w (`-Xptxas -v`, sm_90a), no spills: 146 in half
// modes, 168 in f32 mode.

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_sync.cuh"

namespace {

using namespace mma_sync;

constexpr int NT = 256;          // threads per block
constexpr int TM = 64;           // orders per ls_mix block
constexpr int NG = 8;            // output channels per ls_mix thread
constexpr int TW = 64;           // (i, o) tile edge of an ls_bwd_w block
constexpr int SMEM_MAX = 232448;  // 227 KB, the most a block may opt in to

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

__host__ __device__ inline int pad_ng(int n) { return (n + NG - 1) / NG * NG; }

__host__ __device__ inline int n_tiles(int n, int t) { return n > 0 ? (n + t - 1) / t : 1; }

long long mix_smem_floats(int K, int KC, int NC) {
  // the weight chunk [KC][NC] and the x (or g) chunk [KC][TM], re/im, and
  // the partial sums [NC][TM] where more than one chunk covers K
  return 2LL * KC * NC + 2LL * KC * TM + (n_tiles(K, KC) > 1 ? 2LL * NC * TM : 0);
}

// ---------------------------------------------------------------------------
// Staging: ws[l][k][n] = w[i][o][l] as f32 (re, then im after L*I*O floats),
// with (k, n) = (i, o) for ls_fwd and (o, i) for ls_bwd_x.  Threads walk w in
// its own order, so the reads coalesce.
// ---------------------------------------------------------------------------
template <int FMT, bool BWD>
__global__ void __launch_bounds__(NT)
ls_stage_w_kernel(const typename Fmt<FMT>::T* __restrict__ wr,
                  const typename Fmt<FMT>::T* __restrict__ wi,
                  float* __restrict__ ws, int I, int O, int L) {
  using F = Fmt<FMT>;
  const size_t total = static_cast<size_t>(I) * O * L;
  for (size_t e = static_cast<size_t>(blockIdx.x) * NT + threadIdx.x; e < total;
       e += static_cast<size_t>(gridDim.x) * NT) {
    const size_t l = e % L, io = e / L;
    const size_t o = io % O, i = io / O;
    const size_t dst = BWD ? (l * O + o) * I + i : (l * I + i) * O + o;
    ws[dst] = F::ld(wr[e]);
    ws[total + dst] = F::ld(wi[e]);
  }
}

// ---------------------------------------------------------------------------
// ls_mix: block (order tile m0..m0+TM, degree l, batch row b x output chunk).
//   out[b][n][l][m] = sum_k a[b][k][l][m] * W[k][n]      (BWD: * conj(W[k][n]))
// over output channels n0..n0+NC (NC a multiple of NG), input channels in
// chunks of KC (CHUNKED), or all K at once (one chunk: no partial sums).
// ---------------------------------------------------------------------------
template <int FMT, bool BWD, bool CHUNKED>
__global__ void __launch_bounds__(NT)
ls_mix_kernel(const typename Fmt<FMT>::T* __restrict__ ar,
              const typename Fmt<FMT>::T* __restrict__ ai,
              const float* __restrict__ ws,
              typename Fmt<FMT>::T* __restrict__ outr,
              typename Fmt<FMT>::T* __restrict__ outi,
              int K, int N, int L, int M, int KC, int NC) {
  using F = Fmt<FMT>;
  extern __shared__ __align__(16) float smem[];
  float* swr = smem;            // the W chunk, [KC][NC], zero past N
  float* swi = swr + KC * NC;
  float* sar = swi + KC * NC;   // the a chunk, [KC][TM], zero past M
  float* sai = sar + KC * TM;
  float* spr = sai + KC * TM;   // partial sums, [NC][TM], if K takes chunks
  float* spi = spr + NC * TM;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TM;
  const int nnc = n_tiles(pad_ng(N), NC);
  const size_t l = blockIdx.y, b = blockIdx.z / nnc;
  const int n0 = (blockIdx.z % nnc) * NC, ncp = min(NC, pad_ng(N) - n0);
  const int nkc = CHUNKED ? n_tiles(K, KC) : 1;
  const size_t kn = static_cast<size_t>(K) * N;
  const float* wlr = ws + l * kn;
  const float* wli = ws + static_cast<size_t>(L) * kn + l * kn;

  for (int c = 0; c < nkc; ++c) {
    const int k0 = c * KC, nk = CHUNKED ? min(KC, K - k0) : K;
    if (c > 0) __syncthreads();
    for (int t = tid; t < nk * NC; t += NT) {
      const int k = k0 + t / NC, n = n0 + t % NC;
      swr[t] = n < N ? wlr[static_cast<size_t>(k) * N + n] : 0.f;
      swi[t] = n < N ? wli[static_cast<size_t>(k) * N + n] : 0.f;
    }
    for (int t = tid; t < nk * TM; t += NT) {
      const int k = k0 + t / TM, m = m0 + t % TM;
      float vr = 0.f, vi = 0.f;
      if (m < M) {
        const size_t off = ((b * K + k) * L + l) * M + m;
        vr = F::ld(ar[off]);
        vi = F::ld(ai[off]);
      }
      sar[t] = vr;
      sai[t] = vi;
    }
    __syncthreads();

    for (int t = tid; t < (ncp / NG) * TM; t += NT) {
      const int j0 = NG * (t / TM), mm = t % TM, m = m0 + mm;
      if (m >= M) continue;
      float accr[NG], acci[NG];
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        accr[j] = CHUNKED && c > 0 ? spr[(j0 + j) * TM + mm] : 0.f;
        acci[j] = CHUNKED && c > 0 ? spi[(j0 + j) * TM + mm] : 0.f;
      }
      for (int k = 0; k < nk; ++k) {
        const float xr = sar[k * TM + mm], xi = sai[k * TM + mm];
        const float4 r0 = *reinterpret_cast<const float4*>(swr + k * NC + j0);
        const float4 r1 = *reinterpret_cast<const float4*>(swr + k * NC + j0 + 4);
        const float4 i0 = *reinterpret_cast<const float4*>(swi + k * NC + j0);
        const float4 i1 = *reinterpret_cast<const float4*>(swi + k * NC + j0 + 4);
        const float pr[NG] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
        const float pi[NG] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          if (BWD) {   // a * conj(W)
            accr[j] = fmaf(xr, pr[j], accr[j]);
            accr[j] = fmaf(xi, pi[j], accr[j]);
            acci[j] = fmaf(xi, pr[j], acci[j]);
            acci[j] = fmaf(-xr, pi[j], acci[j]);
          } else {     // a * W
            accr[j] = fmaf(xr, pr[j], accr[j]);
            accr[j] = fmaf(-xi, pi[j], accr[j]);
            acci[j] = fmaf(xr, pi[j], acci[j]);
            acci[j] = fmaf(xi, pr[j], acci[j]);
          }
        }
      }
      if (CHUNKED && c < nkc - 1) {
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          spr[(j0 + j) * TM + mm] = accr[j];
          spi[(j0 + j) * TM + mm] = acci[j];
        }
        continue;
      }
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int n = n0 + j0 + j;
        if (n >= N) break;
        const size_t off = ((b * N + n) * L + l) * M + m;
        outr[off] = F::st(accr[j]);
        outi[off] = F::st(acci[j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// ls_bwd_w: block (degree l, 64-channel tile of i, 64-channel tile of o) of
// 8 warps.  The (b, m) terms stream through a ring of STAGES chunks, a chunk
// being one batch row b and MC orders (ROW bytes of every row) of xr, xi,
// gr and gi.  Warps 0-3 sum the first MC/2 orders of each chunk and warps
// 4-7 the last MC/2, each warp a 32 x 32 quadrant of the (i, o) tile; at the
// end warps 0-3 add warps 4-7's partial sums to their own, in that order,
// and store.  The ring per element size: rows of 256 bytes in three stages
// for halves, 128 bytes in four for f32 (`tools/kernel_trials.py` times
// 128-byte rows in half modes too).
// ---------------------------------------------------------------------------
template <typename T>
struct BwRing {
  static constexpr int STAGES = sizeof(T) == 2 ? 3 : 4;
  static constexpr int ROW = sizeof(T) == 2 ? 256 : 128;   // bytes of a chunk's row
  static constexpr int PITCH = ROW + 16;   // padded: ldmatrix and float2 reads conflict-free
  static constexpr int PLANE = TW * PITCH;                 // one of xr, xi, gr, gi
  static constexpr int STAGE = 4 * PLANE;
  static constexpr int SMEM = STAGES * STAGE;              // 204 KB (halves), 144 KB (f32)
};

template <int FMT, bool VEC>
__global__ void __launch_bounds__(NT, 1)   // one block an SM: its ring fills shared memory
ls_bwd_w_kernel(const typename Fmt<FMT>::T* __restrict__ xr,
                const typename Fmt<FMT>::T* __restrict__ xi,
                const typename Fmt<FMT>::T* __restrict__ gr,
                const typename Fmt<FMT>::T* __restrict__ gi,
                typename Fmt<FMT>::T* __restrict__ dwr,
                typename Fmt<FMT>::T* __restrict__ dwi,
                int B, int I, int O, int L, int M) {
  using F = Fmt<FMT>;
  using T = typename F::T;
  using R = BwRing<T>;
  constexpr bool HALF = FMT != FMT_F32;
  constexpr int MC = R::ROW / static_cast<int>(sizeof(T));     // orders of a chunk
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));        // elements of 16 bytes
  constexpr int PITCH = R::PITCH / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = warp >> 2, wq = warp & 3, wi = wq >> 1, wo = wq & 1;
  const size_t l = blockIdx.x;
  const int i0 = blockIdx.y * TW, o0 = blockIdx.z * TW;
  const int ni = min(TW, I - i0), no = min(TW, O - o0);
  const int ncm = (M + MC - 1) / MC;
  const int nch = B * ncm;

  auto plane = [&](int slot, int a) {
    return reinterpret_cast<T*>(smem_raw + slot * R::STAGE + a * R::PLANE);
  };
  // stage chunk qc into ring slot qc % STAGES, zero past M and the tile
  auto stage_chunk = [&](int qc) {
    if (qc < nch) {
      const size_t b = qc / ncm;
      const int m0 = (qc % ncm) * MC, slot = qc % R::STAGES;
      constexpr int UNIT = VEC ? EPC : 1;       // elements a thread moves at once
      constexpr int PER_ROW = MC / UNIT;
      for (int e = tid; e < 4 * TW * PER_ROW; e += NT) {
        const int a = e / (TW * PER_ROW), r = (e / PER_ROW) % TW, c = (e % PER_ROW) * UNIT;
        const bool isx = a < 2;
        const bool ok = r < (isx ? ni : no) && m0 + c < M;
        const size_t row = isx ? b * I + i0 + r : b * O + o0 + r;
        const size_t off = ok ? (row * L + l) * M + m0 + c : 0;
        const T* base = a == 0 ? xr : a == 1 ? xi : a == 2 ? gr : gi;
        T* dst = plane(slot, a) + r * PITCH + c;
        if (VEC) {
          cp_async16(smem_addr(dst), base + off, ok ? 16 : 0);
        } else {
          *dst = ok ? base[off] : F::st(0.f);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int qc = 0; qc < R::STAGES - 1; ++qc) stage_chunk(qc);

  // half: [re/im][m16 tile][n8 tile][fragment]; f32: [re/im][i row][o column]
  constexpr int NACC = 64;
  float acc[NACC];
#pragma unroll
  for (int t = 0; t < NACC; ++t) acc[t] = 0.f;
  // half: the fragments' row g and column pair t4; f32: the register tile's
  // row g and column t4
  const int g = lane >> 2, t4 = lane & 3;

  for (int qc = 0; qc < nch; ++qc) {
    cp_async_wait<R::STAGES - 2>();   // chunk qc has landed
    __syncthreads();                  // and every warp is done with chunk qc - 1
    stage_chunk(qc + R::STAGES - 1);
    const int slot = qc % R::STAGES;
    const T* sxr = plane(slot, 0);
    const T* sxi = plane(slot, 1);
    const T* sgr = plane(slot, 2);
    const T* sgi = plane(slot, 3);
    if constexpr (HALF) {
      // dw_r += xr.gr^T + xi.gi^T, dw_i += xr.gi^T + xi.(-gr)^T, MC/32 k16 steps
#pragma unroll
      for (int ks = 0; ks < MC / 32; ++ks) {
        const int mk = (MC / 2) * kg + 16 * ks;
        uint32_t ar[2][4], ai[2][4], br[4][2], bi[4][2], bn[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          // matrices: rows +0 / +8 at orders mk, then at mk + 8
          const int off = (32 * wi + 16 * mi + (lane & 7) + 8 * ((lane >> 3) & 1)) * PITCH +
                          mk + 8 * (lane >> 4);
          ldsm_x4(ar[mi], smem_addr(sxr + off));
          ldsm_x4(ai[mi], smem_addr(sxi + off));
        }
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          // matrices: n8 tile j at orders mk / mk + 8, then tile j + 1
          const int off = (32 * wo + 8 * (j + (lane >> 4)) + (lane & 7)) * PITCH + mk +
                          8 * ((lane >> 3) & 1);
          uint32_t t[4];
          ldsm_x4(t, smem_addr(sgr + off));
          br[j][0] = t[0];
          br[j][1] = t[1];
          br[j + 1][0] = t[2];
          br[j + 1][1] = t[3];
          ldsm_x4(t, smem_addr(sgi + off));
          bi[j][0] = t[0];
          bi[j][1] = t[1];
          bi[j + 1][0] = t[2];
          bi[j + 1][1] = t[3];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bn[j][0] = neg2(br[j][0]);
          bn[j][1] = neg2(br[j][1]);
        }
        // one product kind at a time, so consecutive mma's update other tiles
        auto mma_all = [&](int part, const uint32_t (&a)[2][4], const uint32_t (&b)[4][2]) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float* c = acc + ((part * 2 + mi) * 4 + j) * 4;
              float d[4] = {c[0], c[1], c[2], c[3]};
              mma16816<T>(d, a[mi], b[j][0], b[j][1]);
              c[0] = d[0];
              c[1] = d[1];
              c[2] = d[2];
              c[3] = d[3];
            }
          }
        };
        mma_all(0, ar, br);
        mma_all(0, ai, bi);
        mma_all(1, ar, bi);
        mma_all(1, ai, bn);
      }
    } else {
      // conj(x) . g as f32 FMAs, two orders a step: thread (g, t4) owns
      // i = 32 wi + g + 8r and o = 32 wo + t4 + 4c
#pragma unroll 2
      for (int step = 0; step < MC / 4; ++step) {
        const int mm = (MC / 2) * kg + 2 * step;
        float2 px[4], qx[4], pg[8], qg[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int off = (32 * wi + g + 8 * r) * PITCH + mm;
          px[r] = *reinterpret_cast<const float2*>(sxr + off);
          qx[r] = *reinterpret_cast<const float2*>(sxi + off);
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int off = (32 * wo + t4 + 4 * c) * PITCH + mm;
          pg[c] = *reinterpret_cast<const float2*>(sgr + off);
          qg[c] = *reinterpret_cast<const float2*>(sgi + off);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float ar_ = h ? px[r].y : px[r].x, ai_ = h ? qx[r].y : qx[r].x;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const float br_ = h ? pg[c].y : pg[c].x, bi_ = h ? qg[c].y : qg[c].x;
              float& sr = acc[r * 8 + c];
              float& si = acc[32 + r * 8 + c];
              sr = fmaf(ar_, br_, sr);    // conj(x) * g
              sr = fmaf(ai_, bi_, sr);
              si = fmaf(ar_, bi_, si);
              si = fmaf(-ai_, br_, si);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // warps 4-7 hand their partial sums to warps 0-3 through the ring's memory
  float* red = reinterpret_cast<float*>(smem_raw) + wq * NACC * 32 + lane;
  if (kg == 1) {
#pragma unroll
    for (int t = 0; t < NACC; ++t) red[t * 32] = acc[t];
  }
  __syncthreads();
  if (kg == 1) return;
#pragma unroll
  for (int t = 0; t < NACC; ++t) acc[t] += red[t * 32];
#pragma unroll
  for (int t = 0; t < NACC; ++t) {
    int i, o;
    if constexpr (HALF) {   // t = ((re/im * 2 + mi) * 4 + j) * 4 + e
      const int e = t & 3, j = (t >> 2) & 3, mi = (t >> 4) & 1;
      i = 32 * wi + 16 * mi + g + 8 * (e >> 1);
      o = 32 * wo + 8 * j + 2 * t4 + (e & 1);
    } else {                // t = (re/im * 4 + r) * 8 + c
      const int c = t & 7, r = (t >> 3) & 3;
      i = 32 * wi + g + 8 * r;
      o = 32 * wo + t4 + 4 * c;
    }
    if (i >= ni || o >= no) continue;
    const size_t off = (static_cast<size_t>(i0 + i) * O + o0 + o) * L + l;
    (t < NACC / 2 ? dwr : dwi)[off] = F::st(acc[t]);
  }
}

template <int FMT, bool BWD>
int launch_mix(const void* ar, const void* ai, const void* wr, const void* wi,
               void* outr, void* outi, float* ws, int B, int I, int O, int L, int M,
               int KC, int NC, cudaStream_t stream) {
  using T = typename Fmt<FMT>::T;
  const int K = BWD ? O : I, N = BWD ? I : O;
  const size_t smem = mix_smem_floats(K, KC, NC) * sizeof(float);
  if (smem > SMEM_MAX || KC < 1 || NC < NG || NC % NG != 0) return -2;
  // opt in to more than 48 KB of dynamic shared memory once, at the first
  // launch (never inside a CUDA graph capture, which follows a warm-up)
  static const cudaError_t opted[2] = {
      cudaFuncSetAttribute(ls_mix_kernel<FMT, BWD, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX),
      cudaFuncSetAttribute(ls_mix_kernel<FMT, BWD, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX)};
  if (opted[0] != cudaSuccess) return static_cast<int>(opted[0]);
  if (opted[1] != cudaSuccess) return static_cast<int>(opted[1]);
  const size_t total = static_cast<size_t>(I) * O * L;
  if (total > 0) {   // no channels: the products are empty sums, zeros
    const int stage_blocks = static_cast<int>(std::min<size_t>((total + NT - 1) / NT, 4096));
    ls_stage_w_kernel<FMT, BWD><<<stage_blocks, NT, 0, stream>>>(
        static_cast<const T*>(wr), static_cast<const T*>(wi), ws, I, O, L);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  const dim3 grid(n_tiles(M, TM), L, B * n_tiles(pad_ng(N), NC));
  auto* kernel = n_tiles(K, KC) > 1 ? ls_mix_kernel<FMT, BWD, true>
                                    : ls_mix_kernel<FMT, BWD, false>;
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(ar), static_cast<const T*>(ai), ws, static_cast<T*>(outr),
      static_cast<T*>(outi), K, N, L, M, KC, NC);
  return static_cast<int>(cudaGetLastError());
}

template <int FMT>
int launch_bwd_w(const void* xr, const void* xi, const void* gr, const void* gi,
                 void* dwr, void* dwi, int B, int I, int O, int L, int M,
                 cudaStream_t stream) {
  using T = typename Fmt<FMT>::T;
  // opt in to more than 48 KB of dynamic shared memory once, at the first
  // launch (never inside a CUDA graph capture, which follows a warm-up)
  constexpr int smem = BwRing<T>::SMEM;
  static const cudaError_t opted[2] = {
      cudaFuncSetAttribute(ls_bwd_w_kernel<FMT, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem),
      cudaFuncSetAttribute(ls_bwd_w_kernel<FMT, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem)};
  if (opted[0] != cudaSuccess) return static_cast<int>(opted[0]);
  if (opted[1] != cudaSuccess) return static_cast<int>(opted[1]);
  // 16-byte copies need 16-byte rows and operands
  bool vec = (static_cast<size_t>(M) * sizeof(T)) % 16 == 0;
  for (const void* p : {xr, xi, gr, gi}) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const dim3 grid(L, n_tiles(I, TW), n_tiles(O, TW));
  auto* kernel = vec ? ls_bwd_w_kernel<FMT, true> : ls_bwd_w_kernel<FMT, false>;
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi), static_cast<const T*>(gr),
      static_cast<const T*>(gi), static_cast<T*>(dwr), static_cast<T*>(dwi), B, I, O, L, M);
  return static_cast<int>(cudaGetLastError());
}

template <bool BWD>
int dispatch_mix(const void* ar, const void* ai, const void* wr, const void* wi,
                 void* outr, void* outi, void* workspace, int B, int I, int O, int L,
                 int M, int KC, int NC, int fmt, void* stream) {
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case FMT_F32:
      return launch_mix<FMT_F32, BWD>(ar, ai, wr, wi, outr, outi, ws, B, I, O, L, M, KC,
                                      NC, s);
    case FMT_BF16:
      return launch_mix<FMT_BF16, BWD>(ar, ai, wr, wi, outr, outi, ws, B, I, O, L, M, KC,
                                       NC, s);
    case FMT_F16:
      return launch_mix<FMT_F16, BWD>(ar, ai, wr, wi, outr, outi, ws, B, I, O, L, M, KC,
                                      NC, s);
  }
  return -1;
}

}  // namespace

// C interface, loaded with ctypes.  The launchers launch on `stream`,
// allocate nothing, and return cudaGetLastError(), -1 for an unknown format
// code or -2 for a channel plan (KC input, NC output channels per chunk)
// whose working set exceeds a block's shared memory (the Python wrapper
// plans within it).  ls_fwd and ls_bwd_x take an f32 workspace of
// spectral_contract_ls_workspace(I, O, L) floats.

// bytes of shared memory an ls_fwd (K = I) or ls_bwd_x (K = O) block needs
// under the plan (KC, NC)
extern "C" long long spectral_contract_ls_smem(int K, int KC, int NC) {
  return mix_smem_floats(K, KC, NC) * static_cast<long long>(sizeof(float));
}

extern "C" long long spectral_contract_ls_workspace(int I, int O, int L) {
  return 2LL * I * O * L;
}

extern "C" int spectral_contract_ls_fwd(const void* xr, const void* xi, const void* wr,
                                        const void* wi, void* outr, void* outi,
                                        void* workspace, int B, int I, int O, int L, int M,
                                        int KC, int NC, int fmt, void* stream) {
  return dispatch_mix<false>(xr, xi, wr, wi, outr, outi, workspace, B, I, O, L, M, KC, NC,
                             fmt, stream);
}

extern "C" int spectral_contract_ls_bwd_x(const void* gr, const void* gi, const void* wr,
                                          const void* wi, void* dxr, void* dxi,
                                          void* workspace, int B, int I, int O, int L,
                                          int M, int KC, int NC, int fmt, void* stream) {
  return dispatch_mix<true>(gr, gi, wr, wi, dxr, dxi, workspace, B, I, O, L, M, KC, NC,
                            fmt, stream);
}

extern "C" int spectral_contract_ls_bwd_w(const void* xr, const void* xi, const void* gr,
                                          const void* gi, void* dwr, void* dwi, int B,
                                          int I, int O, int L, int M, int fmt,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case FMT_F32:
      return launch_bwd_w<FMT_F32>(xr, xi, gr, gi, dwr, dwi, B, I, O, L, M, s);
    case FMT_BF16:
      return launch_bwd_w<FMT_BF16>(xr, xi, gr, gi, dwr, dwi, B, I, O, L, M, s);
    case FMT_F16:
      return launch_bwd_w<FMT_F16>(xr, xi, gr, gi, dwr, dwi, B, I, O, L, M, s);
  }
  return -1;
}

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
//  * ls_fwd and ls_bwd_x are one kernel, ls_mix: per degree l a batched
//    complex GEMM out(N x M) = W(N x K) . a(K x M) over each batch row,
//    K = I, N = O and W = w[:, :, l]^T (forward), or K = O, N = I and
//    W = conj(w[:, :, l]) (bwd_x), a = x or g.  A block of 8 warps takes
//    one degree and a tile of NC = 64 output channels (and, where the grid
//    would leave SMs idle, a share of the batch rows: `splits`), keeps the
//    weight's degree slice resident in shared memory, read once, and
//    streams the (batch row, 128-order chunk, input-channel chunk) tiles
//    of a past it through a ring of 2 stages filled by 16-byte cp.async
//    (elementwise where M or an operand is off 16 bytes), so W is read once
//    per degree and a and out once each.  w[:, :, l] is strided by L in w:
//    the block gathers its slice straight from w (from L2: w is 2 MB at the
//    path in bf16), no staging pass.
//    Half modes: mma.sync m16n8k16 with f32 accumulators, W as A (stored
//    [n][k], ldmatrix) and a as B (stored [k][m], ldmatrix.trans), each
//    warp a 32 x 32 (channel x order) tile of the 64 x 128 output chunk,
//    the imaginary part's sign flipped on the fragment (exact); outputs go
//    through shared memory to 16-byte rows along m.  f32 mode: the CUDA
//    cores (store_budget assumes exact products, which TF32 would not
//    give), each thread a 4 x 8 complex register tile (4 channels, 8
//    orders) fed by float4 reads of a and broadcast float4 reads of W
//    ([k][n]): 6 shared loads per 128 FMAs; outputs stored as float4.
//    Wider inputs than one chunk (KC = 64 halves, 32 f32) add the chunks
//    into the same accumulators in order; the W slice stays resident up to
//    K = 448 (halves) / 320 (f32), past that each stage carries its chunk
//    of W too (gathered with plain loads).  Every sum runs over k in
//    ascending order in one accumulator, whatever the width or the split,
//    so a rerun is bit-identical.  The host (`ls_plan` in
//    kernels/spectral_contract.py) picks the resident or streamed W and
//    the split before the launch; every width fits.
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
// Registers (`-Xptxas -v`, sm_90a), no spills: ls_mix 162-166 in half
// modes, 152-154 in f32 mode; ls_bwd_w 146 in half modes, 168 in f32 mode.

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_sync.cuh"

namespace {

using namespace mma_sync;

constexpr int NT = 256;          // threads per block
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


__host__ __device__ inline int n_tiles(int n, int t) { return n > 0 ? (n + t - 1) / t : 1; }

// ---------------------------------------------------------------------------
// ls_mix: block (degree l, tile of NC output channels, split s) of 8 warps.
//   out[b][n][l][m] = sum_k a[b][k][l][m] * W[n][k]
//   W[n][k] = w[k][n][l] (forward), conj(w[n][k][l]) (BWD)
// The block's outputs (batch row b, chunk of MC orders) are its share of
// B * ceil(M / MC); each is summed over ceil(K / KC) stages, one input
// chunk of KC channels a stage.  A stage holds the a tile [KC][MC + pad]
// (re, im) and, where W is not resident, the stage's chunk of W.
// ---------------------------------------------------------------------------
template <typename T>
struct MixTile {
  static constexpr bool HALF = sizeof(T) == 2;
  static constexpr int STAGES = 2;               // 3 and 4 ran 1-3 % slower
  static constexpr int KC = HALF ? 64 : 32;       // input channels a stage
  static constexpr int MC = 128;                  // orders a stage
  static constexpr int NC = 64;                   // output channels a block
  static constexpr int EPC = 16 / static_cast<int>(sizeof(T));   // elements of 16 bytes
  static constexpr int AP = MC + EPC;             // a row's pitch: padded by 16 bytes
  static constexpr int A_PLANE = KC * AP;
  // a stage's chunk of W: halves [NC][KC + 8] (k contiguous, for ldmatrix),
  // f32 [KC][NC] (n contiguous, for float4 reads)
  static constexpr int WSP = HALF ? KC + 8 : NC;
  static constexpr int W_PLANE_S = HALF ? NC * WSP : KC * NC;
  static constexpr int OP = MC + 8;               // half: the output tile's pitch
  static constexpr int NACC = 64;                 // f32 accumulators a thread

  // pitch of the resident W for kpad input channels, and one plane's elements
  __host__ __device__ static int wres_pitch(int kpad) { return HALF ? kpad + 8 : NC; }
  __host__ __device__ static long long wres_plane(int kpad) {
    return HALF ? 1LL * NC * (kpad + 8) : 1LL * kpad * NC;
  }
  static long long smem(int K, bool wres) {
    const int kpad = n_tiles(K, KC) * KC;
    const long long stage = 2LL * A_PLANE + (wres ? 0 : 2LL * W_PLANE_S);
    const long long w = wres ? 2 * wres_plane(kpad) : 0;
    const long long out = HALF ? 2LL * NC * OP : 0;
    return (STAGES * stage + w + out) * static_cast<long long>(sizeof(T));
  }
};

template <int FMT, bool BWD>
__global__ void __launch_bounds__(NT, 1)   // one block an SM: its ring and W fill shared memory
ls_mix_kernel(const typename Fmt<FMT>::T* __restrict__ ar,
              const typename Fmt<FMT>::T* __restrict__ ai,
              const typename Fmt<FMT>::T* __restrict__ wr,
              const typename Fmt<FMT>::T* __restrict__ wi,
              typename Fmt<FMT>::T* __restrict__ outr,
              typename Fmt<FMT>::T* __restrict__ outi,
              int B, int K, int N, int L, int M, int wres, int vec, int splits) {
  using F = Fmt<FMT>;
  using T = typename F::T;
  using R = MixTile<T>;
  constexpr bool HALF = R::HALF;
  constexpr int KC = R::KC, MC = R::MC, NC = R::NC, AP = R::AP, EPC = R::EPC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t l = blockIdx.x;
  const int n0 = blockIdx.y * NC, nn = min(NC, N - n0);
  const int nkc = n_tiles(K, KC), kpad = nkc * KC;
  const int nmc = n_tiles(M, MC), outputs = B * nmc;
  const int per = n_tiles(outputs, splits);
  const int o_begin = blockIdx.z * per, o_end = min(outputs, o_begin + per);
  const int nitems = max(0, o_end - o_begin) * nkc;

  const int stage_elems = 2 * R::A_PLANE + (wres ? 0 : 2 * R::W_PLANE_S);
  T* const ring = sm;
  T* const res_r = sm + R::STAGES * stage_elems;
  T* const res_i = res_r + R::wres_plane(kpad);
  T* const out_r = res_r + (wres ? 2 * R::wres_plane(kpad) : 0);   // halves: the output tile
  T* const out_i = out_r + NC * R::OP;

  // W's channels k0 .. k0 + nk into (dr, di), zero past K and N: halves
  // [n][k] at `pitch`, f32 [k][n]
  auto gather_w = [&](T* dr, T* di, int pitch, int k0, int nk) {
#pragma unroll 4
    for (int e = tid; e < NC * nk; e += NT) {
      // threads along the axis that is strided by L alone in w
      const int n = BWD ? e / nk : e % NC, k = BWD ? e % nk : e / NC;
      const bool ok = n < nn && k0 + k < K;
      const size_t src = BWD ? (static_cast<size_t>(n0 + n) * K + k0 + k) * L + l
                             : (static_cast<size_t>(k0 + k) * N + n0 + n) * L + l;
      const T vr = ok ? wr[src] : F::st(0.f), vi = ok ? wi[src] : F::st(0.f);
      const int dst = HALF ? n * pitch + k : k * NC + n;
      dr[dst] = vr;
      di[dst] = vi;
    }
  };

  // stage q: the a tile of item q into ring slot q % STAGES (and its W chunk)
  auto stage = [&](int q) {
    if (q < nitems) {
      const int o = o_begin + q / nkc, k0 = (q % nkc) * KC;
      const size_t b = o / nmc;
      const int m0 = (o % nmc) * MC;
      T* st = ring + (q % R::STAGES) * stage_elems;
      if (vec) {
        constexpr int UPR = MC / EPC;   // 16-byte units a row
        for (int e = tid; e < 2 * KC * UPR; e += NT) {
          const int p = e / (KC * UPR), r = (e / UPR) % KC, c = (e % UPR) * EPC;
          const bool ok = k0 + r < K && m0 + c < M;
          const size_t off = ok ? ((b * K + k0 + r) * L + l) * M + m0 + c : 0;
          cp_async16(smem_addr(st + p * R::A_PLANE + r * AP + c), (p ? ai : ar) + off,
                     ok ? 16 : 0);
        }
      } else {
        for (int e = tid; e < 2 * KC * MC; e += NT) {
          const int p = e / (KC * MC), r = (e / MC) % KC, c = e % MC;
          const bool ok = k0 + r < K && m0 + c < M;
          const size_t off = ok ? ((b * K + k0 + r) * L + l) * M + m0 + c : 0;
          st[p * R::A_PLANE + r * AP + c] = ok ? (p ? ai : ar)[off] : F::st(0.f);
        }
      }
      if (!wres) {
        T* sw = st + 2 * R::A_PLANE;
        gather_w(sw, sw + R::W_PLANE_S, R::WSP, k0, KC);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int q = 0; q < R::STAGES - 1; ++q) stage(q);
  if (wres) gather_w(res_r, res_i, R::wres_pitch(kpad), 0, kpad);   // seen after the first barrier

  float acc[R::NACC];
#pragma unroll
  for (int t = 0; t < R::NACC; ++t) acc[t] = 0.f;
  // half: the warp's 32 x 32 tile (channels 32 wn.., orders 32 wm..) and the
  // fragments' row g and column pair t4; f32: the thread's channels 4 tn..
  // and orders 4 tm.. and 64 + 4 tm..
  const int wn = warp >> 2, wm = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int tn = tid >> 4, tm = tid & 15;

  for (int q = 0; q < nitems; ++q) {
    cp_async_wait<R::STAGES - 2>();   // item q has landed
    __syncthreads();                  // and every warp is done with item q - 1
    stage(q + R::STAGES - 1);
    const int o = o_begin + q / nkc, kc = q % nkc, k0 = kc * KC;
    const size_t b = o / nmc;
    const int m0 = (o % nmc) * MC;
    const int nk = min(KC, K - k0);   // input channels of this stage (rows past are zero)
    const T* st = ring + (q % R::STAGES) * stage_elems;
    const T* sar = st;
    const T* sai = st + R::A_PLANE;
    const T* swr = wres ? res_r : st + 2 * R::A_PLANE;
    const T* swi = wres ? res_i : st + 2 * R::A_PLANE + R::W_PLANE_S;
    const int wpitch = wres ? R::wres_pitch(kpad) : R::WSP;
    const int wk0 = wres ? k0 : 0;    // W's column (halves) or row (f32) of the stage's first k

    if constexpr (HALF) {
      if (32 * wn < nn && 32 * wm < M - m0) {
        for (int ks = 0; ks < nk; ks += 16) {
          uint32_t war[2][4], wai[2][4], wan[2][4], br[4][2], bi[4][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            // matrices: channels +0 / +8 at k ks, then at k ks + 8
            const int off = (32 * wn + 16 * mi + (lane & 7) + 8 * ((lane >> 3) & 1)) * wpitch +
                            wk0 + ks + 8 * (lane >> 4);
            ldsm_x4(war[mi], smem_addr(swr + off));
            ldsm_x4(wai[mi], smem_addr(swi + off));
#pragma unroll
            for (int r = 0; r < 4; ++r) wan[mi][r] = neg2(wai[mi][r]);
          }
#pragma unroll
          for (int j = 0; j < 4; j += 2) {
            // matrices: k ks / ks + 8 at orders of tile j, then of tile j + 1
            const int off = (ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * AP + 32 * wm +
                            8 * (j + (lane >> 4));
            uint32_t t[4];
            ldsm_x4_trans(t, smem_addr(sar + off));
            br[j][0] = t[0];
            br[j][1] = t[1];
            br[j + 1][0] = t[2];
            br[j + 1][1] = t[3];
            ldsm_x4_trans(t, smem_addr(sai + off));
            bi[j][0] = t[0];
            bi[j][1] = t[1];
            bi[j + 1][0] = t[2];
            bi[j + 1][1] = t[3];
          }
          // one product kind at a time, so consecutive mma's update other tiles
          auto mma_all = [&](int part, const uint32_t (&a)[2][4], const uint32_t (&bb)[4][2]) {
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                float* c = acc + ((part * 2 + mi) * 4 + j) * 4;
                float d[4] = {c[0], c[1], c[2], c[3]};
                mma16816<T>(d, a[mi], bb[j][0], bb[j][1]);
                c[0] = d[0];
                c[1] = d[1];
                c[2] = d[2];
                c[3] = d[3];
              }
            }
          };
          if (BWD) {   // a * conj(W): re += Wr ar + Wi ai, im += Wr ai - Wi ar
            mma_all(0, war, br);
            mma_all(0, wai, bi);
            mma_all(1, war, bi);
            mma_all(1, wan, br);
          } else {     // a * W: re += Wr ar - Wi ai, im += Wi ar + Wr ai
            mma_all(0, war, br);
            mma_all(0, wan, bi);
            mma_all(1, wai, br);
            mma_all(1, war, bi);
          }
        }
      }
    } else {
      if (8 * warp < nn) {
#pragma unroll 2
        for (int k = 0; k < nk; ++k) {
          const float4 xr0 = *reinterpret_cast<const float4*>(sar + k * AP + 4 * tm);
          const float4 xr1 = *reinterpret_cast<const float4*>(sar + k * AP + 64 + 4 * tm);
          const float4 xi0 = *reinterpret_cast<const float4*>(sai + k * AP + 4 * tm);
          const float4 xi1 = *reinterpret_cast<const float4*>(sai + k * AP + 64 + 4 * tm);
          const float4 pr = *reinterpret_cast<const float4*>(swr + (wk0 + k) * NC + 4 * tn);
          const float4 pi = *reinterpret_cast<const float4*>(swi + (wk0 + k) * NC + 4 * tn);
          const float xr[8] = {xr0.x, xr0.y, xr0.z, xr0.w, xr1.x, xr1.y, xr1.z, xr1.w};
          const float xi[8] = {xi0.x, xi0.y, xi0.z, xi0.w, xi1.x, xi1.y, xi1.z, xi1.w};
          const float vr[4] = {pr.x, pr.y, pr.z, pr.w};
          const float vi[4] = {pi.x, pi.y, pi.z, pi.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              float& sr = acc[r * 8 + c];
              float& si = acc[32 + r * 8 + c];
              if (BWD) {   // a * conj(W)
                sr = fmaf(xr[c], vr[r], sr);
                sr = fmaf(xi[c], vi[r], sr);
                si = fmaf(xi[c], vr[r], si);
                si = fmaf(-xr[c], vi[r], si);
              } else {     // a * W
                sr = fmaf(xr[c], vr[r], sr);
                sr = fmaf(-xi[c], vi[r], sr);
                si = fmaf(xr[c], vi[r], si);
                si = fmaf(xi[c], vr[r], si);
              }
            }
          }
        }
      }
    }
    if (kc < nkc - 1) continue;

    // the output (b, channels n0.., orders m0..) is summed: store it
    auto gaddr = [&](int n, int m) { return ((b * N + n0 + n) * L + l) * M + m0 + m; };
    if constexpr (HALF) {
#pragma unroll
      for (int t = 0; t < R::NACC; t += 2) {   // t = ((re/im * 2 + mi) * 4 + j) * 4 + e
        const int e = t & 3, j = (t >> 2) & 3, mi = (t >> 4) & 1;
        const int n = 32 * wn + 16 * mi + g + 8 * (e >> 1), m = 32 * wm + 8 * j + 2 * t4;
        *reinterpret_cast<uint32_t*>((t < R::NACC / 2 ? out_r : out_i) + n * R::OP + m) =
            pack2<T>(acc[t], acc[t + 1]);
      }
      __syncthreads();
      if (vec) {
        constexpr int UPR = MC / EPC;
        for (int e = tid; e < 2 * NC * UPR; e += NT) {
          const int p = e / (NC * UPR), n = (e / UPR) % NC, m = (e % UPR) * EPC;
          if (n < nn && m0 + m < M)
            *reinterpret_cast<uint4*>((p ? outi : outr) + gaddr(n, m)) =
                *reinterpret_cast<const uint4*>((p ? out_i : out_r) + n * R::OP + m);
        }
      } else {
        for (int e = tid; e < 2 * NC * MC; e += NT) {
          const int p = e / (NC * MC), n = (e / MC) % NC, m = e % MC;
          if (n < nn && m0 + m < M)
            (p ? outi : outr)[gaddr(n, m)] = (p ? out_i : out_r)[n * R::OP + m];
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = 4 * tn + r;
        if (n >= nn) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 64 * h + 4 * tm;
          const float* sr = acc + r * 8 + 4 * h;
          const float* si = acc + 32 + r * 8 + 4 * h;
          if (vec) {
            if (m0 + m < M) {
              *reinterpret_cast<float4*>(outr + gaddr(n, m)) =
                  make_float4(sr[0], sr[1], sr[2], sr[3]);
              *reinterpret_cast<float4*>(outi + gaddr(n, m)) =
                  make_float4(si[0], si[1], si[2], si[3]);
            }
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (m0 + m + c < M) {
                outr[gaddr(n, m + c)] = sr[c];
                outi[gaddr(n, m + c)] = si[c];
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < R::NACC; ++t) acc[t] = 0.f;
  }
  cp_async_wait<0>();
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
               void* outr, void* outi, int B, int I, int O, int L, int M, int wres,
               int splits, cudaStream_t stream) {
  using T = typename Fmt<FMT>::T;
  const int K = BWD ? O : I, N = BWD ? I : O;
  const long long smem = MixTile<T>::smem(K, wres != 0);
  if (smem > SMEM_MAX || splits < 1) return -2;
  // opt in to more than 48 KB of dynamic shared memory once, at the first
  // launch (never inside a CUDA graph capture, which follows a warm-up)
  static const cudaError_t opted = cudaFuncSetAttribute(
      ls_mix_kernel<FMT, BWD>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  // 16-byte copies and stores need 16-byte rows and operands
  bool vec = (static_cast<size_t>(M) * sizeof(T)) % 16 == 0;
  for (const void* p : {ar, ai, static_cast<const void*>(outr), static_cast<const void*>(outi)})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const dim3 grid(L, n_tiles(N, MixTile<T>::NC), splits);
  ls_mix_kernel<FMT, BWD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(ar), static_cast<const T*>(ai), static_cast<const T*>(wr),
      static_cast<const T*>(wi), static_cast<T*>(outr), static_cast<T*>(outi), B, K, N, L, M,
      wres != 0, vec, splits);
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
                 void* outr, void* outi, int B, int I, int O, int L, int M, int wres,
                 int splits, int fmt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case FMT_F32:
      return launch_mix<FMT_F32, BWD>(ar, ai, wr, wi, outr, outi, B, I, O, L, M, wres, splits,
                                      s);
    case FMT_BF16:
      return launch_mix<FMT_BF16, BWD>(ar, ai, wr, wi, outr, outi, B, I, O, L, M, wres,
                                       splits, s);
    case FMT_F16:
      return launch_mix<FMT_F16, BWD>(ar, ai, wr, wi, outr, outi, B, I, O, L, M, wres, splits,
                                      s);
  }
  return -1;
}

}  // namespace

// C interface, loaded with ctypes.  The launchers launch on `stream`,
// allocate nothing, and return cudaGetLastError(), -1 for an unknown format
// code or -2 for a plan whose working set exceeds a block's shared memory
// or a split below 1 (the Python wrapper plans within them).  ls_fwd and
// ls_bwd_x take the plan's `wres` (the weight's degree slice resident in
// shared memory, or streamed a chunk a stage) and `splits` (blocks a
// (degree, channel tile) shares its batch rows and order chunks among).

// bytes of shared memory an ls_fwd (K = I) or ls_bwd_x (K = O) block needs
// in format `fmt` with the weight resident (wres) or streamed; -1 for an
// unknown format code
extern "C" long long spectral_contract_ls_smem(int K, int fmt, int wres) {
  switch (fmt) {
    case FMT_F32:
      return MixTile<float>::smem(K, wres != 0);
    case FMT_BF16:
      return MixTile<__nv_bfloat16>::smem(K, wres != 0);
    case FMT_F16:
      return MixTile<__half>::smem(K, wres != 0);
  }
  return -1;
}

extern "C" int spectral_contract_ls_fwd(const void* xr, const void* xi, const void* wr,
                                        const void* wi, void* outr, void* outi, int B, int I,
                                        int O, int L, int M, int wres, int splits, int fmt,
                                        void* stream) {
  return dispatch_mix<false>(xr, xi, wr, wi, outr, outi, B, I, O, L, M, wres, splits, fmt,
                             stream);
}

extern "C" int spectral_contract_ls_bwd_x(const void* gr, const void* gi, const void* wr,
                                          const void* wi, void* dxr, void* dxi, int B, int I,
                                          int O, int L, int M, int wres, int splits, int fmt,
                                          void* stream) {
  return dispatch_mix<true>(gr, gi, wr, wi, dxr, dxi, B, I, O, L, M, wres, splits, fmt,
                            stream);
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

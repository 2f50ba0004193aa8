// CP-factorised spectral contraction (TFNO), forward and backward, for
// Hopper (sm_90a).
//
// Replace the TPU kernels `_cp_fwd_kernel` (cp_fwd) and `_cp_bwd_kernel`
// (cp_bwd) in src/repro/kernels/spectral_contract.py, reached through
// `spectral_contract_cp_pallas` and its custom VJP `_cp_op_bwd`.  The
// dense weight w[i,o,m] = sum_r U_i[i,r] U_o[o,r] W[r,m] is never formed:
// with the mode factor W[r,m] = lam_r prod_k U_mk[m_k,r] folded outside,
// for every retained Fourier mode m
//
//     t[b,m,r]   = sum_i x[b,i,m] * U_i[i,r]        rank-project
//     u[b,m,r]   = t[b,m,r] * W[r,m]                mode-scale
//     out[b,o,m] = sum_r u[b,m,r] * U_o[o,r]        rank-expand   (cp_fwd)
//
// and, given the cotangent g[b,o,m] (cp_bwd, recomputing t and u):
//
//     du   = sum_o g * conj(U_o)        dU_o = sum_{b,m} g * conj(u)
//     dt   = du * conj(W)               dW   = sum_b du * conj(t)
//     dx   = sum_r dt * conj(U_i)       dU_i = sum_{b,m} conj(x) * dt
//
// all complex, in split-real form.  Every operand (x, U_i, U_o, W and g)
// arrives at one dtype T (f32, bf16 or fp16: the caller rounded them to the
// site's storage format).  t, u, du, dt and every sum are f32, never
// rounded: the reference multiplies at preferred_element_type=f32, and a
// product of two bf16 or two fp16 values is exact in f32, so f32 FMAs give
// what its matmuls give up to the order of the sums.  out, dx and dW are
// stored at T; dU_i and dU_o are summed in f32 across mode tiles and then
// stored at T, as `_cp_op_bwd` returns them.
//
// What bounds them.  At the TFNO_NS path's shape (B=8, I=O=R=64,
// M=42*42=1764) cp_fwd does 8*B*M*I*R*2 = 0.925 GFLOP (two complex
// contractions of 4 real FMAs per term); its bytes (x and out 7.2 MB, W
// 0.45 MB at bf16; twice that at f32) take 2.3 us (4.6 us) at 3.35 TB/s.
// cp_bwd does five such contractions, 2.31 GFLOP, against 11.7 MB (bf16)
// of bytes.  In f32 mode every product takes the f32 CUDA cores (67
// TFLOP/s): 13.9 us and 34.8 us.  In a half mode the products of two
// operands at T (t = x*U_i in both kernels, du = g*U_o in cp_bwd) are
// half x half with f32 sums, which the tensor cores compute exactly (989
// TFLOP/s dense).  cp_fwd's rank-expand takes the f32 u, which the tensor
// cores would round; split exactly into three bf16 pieces (fp16 U_o into
// two), it is 3 (6) half products a term there, so cp_fwd's half-mode work
// is 4 (7) x 0.46 GFLOP at the tensor-core rate, 1.9 us (3.3 us), under its
// bytes.  cp_bwd multiplies the f32 dt by U_i (dx) and by x (dU_i) and the
// f32 u by g (dU_o): on the same three-piece split these are 3 half
// products a term (5 with fp16 operands), so its half-mode work is 5.1
// GFLOP at the tensor-core rate, 5.4 us with its f32 mode-scale products,
// bound by operations (counted as f32 products on the CUDA cores, as the
// earlier design did them, it was 21.9 us).
//
// cp_fwd's design: see the block comment above cp_fwd_kernel.  Persistent
// blocks over (batch row, 64-mode) tiles, the factors resident in their own
// dtype, x and W through a cp.async ring, both contractions on mma.sync in
// the half modes (the rank-expand on the exact bf16 split of u), a 4 x 4
// complex register tile a thread on the CUDA cores in f32 mode.  Channel
// chunks (64 ranks, 64 output channels, 64 or 32 input channels an item)
// keep every width within a block's registers and shared memory; the
// accumulators carry over them, so there is no width limit.
//
// cp_bwd's design: see the block comment above cp_bwd_kernel.  Persistent
// blocks, one an SM (132 on the H100), walk (64-mode tile, batch row) items
// (224 at the path's shape) with the next item's x and g in flight through a
// cp.async ring, and all five contractions run on mma.sync, in f32 mode too
// (every operand split in three; six piece products a term).  What holds it
// now is latency more than products: with one block of 8 warps an SM (its
// 221 KB of shared memory) each phase's latency and the first item's loads
// are exposed, and the fixed-order reduction of the dW terms and block
// partials is a second launch.  Channels and ranks come in 64-wide chunks
// whose sums carry over, so it has no width or rank limit.
//
// Neither kernel uses atomics: every output is reduced by one thread (or one
// mma fragment) in a fixed order, so a rerun is bit-identical.

#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_sync.cuh"

namespace {

using namespace mma_sync;

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



// ---------------------------------------------------------------------------
// cp_fwd: persistent blocks, each walking tiles of MT consecutive modes of one
// batch row (tile t = blockIdx.x, + gridDim.x, ...).  A tile's work is a
// stream of items (output-channel chunk oc, rank chunk rc, input-channel
// chunk ic), ic fastest; each item's x chunk [IC][MT] (and, on the last ic of
// an (oc, rc), the W chunk [RC][MT]) comes in through a ring of STAGES slots
// filled by cp.async, so the next item's loads are in flight while one is
// summed.  Where I, R and O are at most RES the factors U_i [I][R] and U_o
// stay resident in shared memory, copied once a block; else each item brings
// its U_i chunk and each (oc, rc) its U_o chunk in the slot too.  The t
// accumulators carry over the input chunks and the out accumulators over the
// rank chunks, so every sum keeps the one-chunk order whatever the widths.
//
// Half modes (NT = 128, a warp 16 modes): stage 1 on mma.sync, x as A
// (ldmatrix.trans of [i][m]) and U_i as B (ldmatrix.trans of [i][r]),
//     t_r += x_r U_ir + x_i (-U_ii)      t_i += x_r U_ii + x_i U_ir,
// then u = t W on the C fragments (W read with ldmatrix.trans of [r][m], which
// gives each lane its fragments' W pair), then stage 3 on mma.sync from
// registers: a C fragment pair is an A fragment, and u = u1 + u2 + u3, each
// piece the bf16 rounding of what the earlier ones leave (exact for |u| above
// bf16's underflow: 3 x (8 + 1) bits cover f32's 24), against U_o as bf16 B
// fragments (ldmatrix of [o][r]; fp16 U_o is split on the fly into two bf16
// pieces, exact since fp16's range lies inside bf16's), so every product is
// exact and every sum f32.  out goes through a tile in the item's slot to
// vector stores along m.
// f32 mode (NT = 256): the CUDA cores, each thread a 4 x 4 complex register
// tile (modes x ranks, then modes x output channels) fed by float4 reads of
// [i][m] x, [i][r] U_i, [r][m] u and [r][o] U_o^T: 4 shared loads per 64 FMAs.
// u goes through the item's slot between the stages.
// ---------------------------------------------------------------------------
__host__ __device__ inline int cdiv(int n, int t) { return n > 0 ? (n + t - 1) / t : 1; }

template <typename T>
struct FwdTile {
  static constexpr bool HALF = sizeof(T) == 2;
  static constexpr int NT = HALF ? 128 : 256;   // threads
  static constexpr int MT = 64;                 // modes a tile
  static constexpr int IC = HALF ? 64 : 32;     // input channels an item
  static constexpr int RC = 64;                 // ranks a chunk
  static constexpr int OC = 64;                 // output channels a chunk
  static constexpr int RES = 64;                // widest I, R and O with resident factors
  static constexpr int STAGES = 2;
  static constexpr int PAD = 16 / static_cast<int>(sizeof(T));   // 16 bytes: ldmatrix and
  static constexpr int XP = MT + PAD;           // float4 reads conflict-free; x, W, u, out
  static constexpr int UP = RC + PAD;           // U_i [i][r]; halves: U_o [o][r]
  static constexpr int OTP = OC + PAD;          // f32: U_o^T [r][o]
  static constexpr int X_PLANE = IC * XP;
  static constexpr int W_PLANE = RC * XP;
  static constexpr int XW = 2 * (X_PLANE + W_PLANE);   // a slot's x and W, re/im
  static constexpr int UI_PLANE = IC * UP;             // a streamed U_i chunk
  static constexpr int UI_RES_PLANE = RES * UP;        // the resident U_i
  static constexpr int UO_PLANE = HALF ? OC * UP : RC * OTP;
  static constexpr int PP = MT + 4;                    // halves: the out partial sums' pitch
  // halves, streamed factors: out's f32 partial sums over the earlier rank
  // chunks, [re/im][OC][PP], after the ring (f32 mode keeps them in registers)
  static constexpr int PART_BYTES = HALF ? 2 * OC * PP * 4 : 0;
  __host__ __device__ static int slot(bool res) {
    return XW + (res ? 0 : 2 * (UI_PLANE + UO_PLANE));
  }
  static long long smem(bool res) {
    const long long elems = static_cast<long long>(STAGES) * slot(res) +
                            (res ? 2 * (UI_RES_PLANE + UO_PLANE) : 0);
    return elems * static_cast<long long>(sizeof(T)) + (res ? 0 : PART_BYTES);
  }
};

// rows [0, nr) x columns [0, nc) of a row-major global matrix at `src` (`ld`
// elements a row) into dst[row * pitch + column], zero past `nrv` rows and
// `ncv` columns: cp.async of `unit` elements (a divisor of the row length) or,
// where that is under 4 bytes, plain loads.  nc / unit is a power of two, so
// a copy's row and column come by shifts.
template <typename T, int NTH>
__device__ __forceinline__ void copy_rows(T* dst, int pitch, const T* src, size_t ld, int nrv,
                                          int ncv, int nr, int nc, int unit, int tid) {
  const int bytes = unit * static_cast<int>(sizeof(T));
  if (bytes < 4) {
    for (int e = tid; e < nr * nc; e += NTH) {
      const int r = e / nc, c = e % nc;
      dst[r * pitch + c] = r < nrv && c < ncv ? src[r * ld + c] : T(0.f);
    }
    return;
  }
  const int sh = __ffs(nc / unit) - 1, mask = (1 << sh) - 1;
  for (int e = tid; e < (nr << sh); e += NTH) {
    const int r = e >> sh, c = (e & mask) * unit;
    const bool ok = r < nrv && c < ncv;
    const T* s = ok ? src + r * ld + c : src;
    const uint32_t d = smem_addr(dst + r * pitch + c);
    if (bytes == 16) {
      cp_async16(d, s, ok ? 16 : 0);
    } else if (bytes == 8) {
      cp_async8(d, s, ok ? 8 : 0);
    } else {
      cp_async4(d, s, ok ? 4 : 0);
    }
  }
}

// src[row * pitch + column] to a row-major global matrix, rows [0, nrv) x
// columns [0, ncv), `unit` elements a store
template <typename T, int NTH>
__device__ __forceinline__ void store_rows(T* dst, size_t ld, const T* src, int pitch, int nrv,
                                           int ncv, int nc, int unit, int tid) {
  const int bytes = unit * static_cast<int>(sizeof(T));
  const int u = bytes >= 4 ? unit : 1, upr = nc / u;
  for (int e = tid; e < nrv * upr; e += NTH) {
    const int r = e / upr, c = (e % upr) * u;
    if (c >= ncv) continue;
    T* d = dst + r * ld + c;
    const T* s = src + r * pitch + c;
    if (bytes >= 16) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else if (bytes == 8) {
      *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s);
    } else if (bytes == 4) {
      *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s);
    } else {
      *d = *s;
    }
  }
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

template <typename T>
__device__ __forceinline__ float2 to_float2(uint32_t v) {
  if constexpr (sizeof(T) == 2 && std::is_same<T, __half>::value) {
    return __half22float2(*reinterpret_cast<const __half2*>(&v));
  } else {
    return bf16x2_to_float2(v);
  }
}

// (lo, hi) = p0 + p1 + p2 exactly, each p the packed bf16 pair rounded to
// nearest from what the earlier pieces leave
__device__ __forceinline__ void split3(float lo, float hi, uint32_t& p0, uint32_t& p1,
                                       uint32_t& p2) {
  p0 = pack2<__nv_bfloat16>(lo, hi);
  const float2 f0 = bf16x2_to_float2(p0);
  const float r0 = lo - f0.x, r1 = hi - f0.y;
  p1 = pack2<__nv_bfloat16>(r0, r1);
  const float2 f1 = bf16x2_to_float2(p1);
  p2 = pack2<__nv_bfloat16>(r0 - f1.x, r1 - f1.y);
}

template <int FMT>
__global__ void __launch_bounds__(FwdTile<typename Fmt<FMT>::T>::NT)
cp_fwd_kernel(const typename Fmt<FMT>::T* __restrict__ xr,
              const typename Fmt<FMT>::T* __restrict__ xi,
              const typename Fmt<FMT>::T* __restrict__ uir,
              const typename Fmt<FMT>::T* __restrict__ uii,
              const typename Fmt<FMT>::T* __restrict__ uor,
              const typename Fmt<FMT>::T* __restrict__ uoi,
              const typename Fmt<FMT>::T* __restrict__ wr,
              const typename Fmt<FMT>::T* __restrict__ wi,
              typename Fmt<FMT>::T* __restrict__ outr,
              typename Fmt<FMT>::T* __restrict__ outi,
              int B, int I, int O, int R, int M, int res, int um, int ur) {
  using F = Fmt<FMT>;
  using T = typename F::T;
  using P = FwdTile<T>;
  constexpr bool HALF = P::HALF;
  constexpr int NT = P::NT, MT = P::MT, IC = P::IC, RC = P::RC, OC = P::OC;
  constexpr int XP = P::XP, UP = P::UP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int nmt = cdiv(M, MT), tiles = B * nmt;
  const int nic = cdiv(I, IC), nrc = cdiv(R, RC), noc = cdiv(O, OC);
  const int per_tile = noc * nrc * nic;
  const int mine = tiles > static_cast<int>(blockIdx.x)
                       ? (tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const int nitems = mine * per_tile;
  const int slot_elems = P::slot(res != 0);
  T* const ring = sm;
  T* const rui = sm + P::STAGES * slot_elems;   // resident U_i [RES][UP], re/im
  T* const ruo = rui + 2 * P::UI_RES_PLANE;     // resident U_o, re/im
  float* const part = reinterpret_cast<float*>(rui);   // streamed factors: out partial sums

  struct Item {
    size_t b;
    int m0, oc, rc, ic;
  };
  auto decode = [&](int q) {
    const int k = q / per_tile, rem = q % per_tile;
    const int tile = blockIdx.x + k * gridDim.x;
    return Item{static_cast<size_t>(tile / nmt), (tile % nmt) * MT, rem / (nrc * nic),
                (rem / nic) % nrc, rem % nic};
  };

  // U_i rows 0..nr of the chunk at input channel i0, rank rc0 into [nr][UP]
  auto stage_ui = [&](T* d, int nr, int i0, int rc0) {
    copy_rows<T, NT>(d, UP, uir + static_cast<size_t>(i0) * R + rc0, R, I - i0, R - rc0, nr, RC,
                     ur, tid);
    copy_rows<T, NT>(d + (res ? P::UI_RES_PLANE : P::UI_PLANE), UP,
                     uii + static_cast<size_t>(i0) * R + rc0, R, I - i0, R - rc0, nr, RC, ur, tid);
  };
  // U_o's chunk (oc0, rc0): halves [o][r] as stored; f32 [r][o], element by element
  auto stage_uo = [&](T* d, int oc0, int rc0) {
    if constexpr (HALF) {
      copy_rows<T, NT>(d, UP, uor + static_cast<size_t>(oc0) * R + rc0, R, O - oc0, R - rc0, OC,
                       RC, ur, tid);
      copy_rows<T, NT>(d + P::UO_PLANE, UP, uoi + static_cast<size_t>(oc0) * R + rc0, R, O - oc0,
                       R - rc0, OC, RC, ur, tid);
    } else {
      for (int e = tid; e < 2 * RC * OC; e += NT) {
        const int p = e / (RC * OC), r = (e / OC) % RC, o = e % OC;
        const bool ok = r < R - rc0 && o < O - oc0;
        const T* base = p ? uoi : uor;
        cp_async4(smem_addr(d + p * P::UO_PLANE + r * P::OTP + o),
                  ok ? base + static_cast<size_t>(oc0 + o) * R + rc0 + r : base, ok ? 4 : 0);
      }
    }
  };

  auto stage = [&](int q) {
    if (q < nitems) {
      const Item it = decode(q);
      T* st = ring + (q % P::STAGES) * slot_elems;
      const int i0 = it.ic * IC, rc0 = it.rc * RC;
      const size_t xo = (it.b * I + i0) * M + it.m0;
      copy_rows<T, NT>(st, XP, xr + xo, M, I - i0, M - it.m0, IC, MT, um, tid);
      copy_rows<T, NT>(st + P::X_PLANE, XP, xi + xo, M, I - i0, M - it.m0, IC, MT, um, tid);
      if (!res) stage_ui(st + P::XW, IC, i0, rc0);
      if (it.ic == nic - 1) {
        const size_t wo = static_cast<size_t>(rc0) * M + it.m0;
        T* sw = st + 2 * P::X_PLANE;
        copy_rows<T, NT>(sw, XP, wr + wo, M, R - rc0, M - it.m0, RC, MT, um, tid);
        copy_rows<T, NT>(sw + P::W_PLANE, XP, wi + wo, M, R - rc0, M - it.m0, RC, MT, um, tid);
        if (!res) stage_uo(st + P::XW + 2 * P::UI_PLANE, it.oc * OC, rc0);
      }
    }
    cp_async_commit();
  };

  if (res && nitems > 0) {   // the factors, once, in the first item's group
    stage_ui(rui, P::RES, 0, 0);
    stage_uo(ruo, 0, 0);
  }
#pragma unroll
  for (int q = 0; q < P::STAGES - 1; ++q) stage(q);

  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int wm = 16 * warp;                  // halves: the warp's modes in the tile
  const int mq = tid & 15, nq = tid >> 4;    // f32: modes 4 mq.., ranks or channels 4 nq..
  // halves: acc_t[re/im][8-wide rank tile][fragment] (out is summed in the
  // stage-3 fragments); f32: [re/im][rank or channel][mode] of the thread's
  // 4 x 4 tile
  constexpr int NJ = HALF ? RC / 8 : 4;
  float acc_t[2][NJ][4], acc_o[2][NJ][4];

  for (int q = 0; q < nitems; ++q) {
    cp_async_wait<P::STAGES - 2>();   // item q has landed
    __syncthreads();                  // and every thread is done with item q - 1
    stage(q + P::STAGES - 1);
    const Item it = decode(q);
    T* st = ring + (q % P::STAGES) * slot_elems;
    const int i0 = it.ic * IC, rc0 = it.rc * RC, oc0 = it.oc * OC;
    const int nk = min(IC, I - i0), nr = min(RC, R - rc0), no = min(OC, O - oc0);
    const int nm = min(MT, M - it.m0);
    const T* sxr = st;
    const T* sxi = st + P::X_PLANE;
    const T* swr = st + 2 * P::X_PLANE;
    const T* swi = swr + P::W_PLANE;
    const T* s_uir = res ? rui + i0 * UP : st + P::XW;
    const T* s_uii = s_uir + (res ? P::UI_RES_PLANE : P::UI_PLANE);
    const T* s_uor = res ? ruo : st + P::XW + 2 * P::UI_PLANE;
    const T* s_uoi = s_uor + P::UO_PLANE;
    if (it.ic == 0) {
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc_t[p][j][e] = 0.f;
            if (it.rc == 0) acc_o[p][j][e] = 0.f;
          }
    }

    if constexpr (HALF) {
      // stage 1: t[m][r] += x[i][m] U_i[i][r] over this chunk's input channels
      if (wm < nm) {
        for (int ks = 0; ks < nk; ks += 16) {
          uint32_t ar[4], ai[4];
          const int xoff = (ks + (lane & 7) + 8 * (lane >> 4)) * XP + wm + 8 * ((lane >> 3) & 1);
          ldsm_x4_trans(ar, smem_addr(sxr + xoff));
          ldsm_x4_trans(ai, smem_addr(sxi + xoff));
#pragma unroll
          for (int j = 0; j < RC / 8; j += 2) {
            if (8 * j < nr) {
              // matrices: k ks / ks + 8 at ranks of tile j, then of tile j + 1
              const int uoff =
                  (ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * UP + 8 * (j + (lane >> 4));
              uint32_t br[4], bi[4];
              ldsm_x4_trans(br, smem_addr(s_uir + uoff));
              ldsm_x4_trans(bi, smem_addr(s_uii + uoff));
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                mma16816<T>(acc_t[0][j + h], ar, br[2 * h], br[2 * h + 1]);
                mma16816<T>(acc_t[1][j + h], ar, bi[2 * h], bi[2 * h + 1]);
              }
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                mma16816<T>(acc_t[0][j + h], ai, neg2(bi[2 * h]), neg2(bi[2 * h + 1]));
                mma16816<T>(acc_t[1][j + h], ai, br[2 * h], br[2 * h + 1]);
              }
            }
          }
        }
      }
      if (it.ic < nic - 1) continue;

      if (wm < nm) {
        // u = t W: the fragments' W pairs, (g, 2t4..) and (g + 8, 2t4..), of tiles j and j + 1
#pragma unroll
        for (int j = 0; j < RC / 8; j += 2) {
          if (8 * j < nr) {
            const int woff = (8 * (j + (lane >> 4)) + (lane & 7)) * XP + wm + 8 * ((lane >> 3) & 1);
            uint32_t vr[4], vi[4];
            ldsm_x4_trans(vr, smem_addr(swr + woff));
            ldsm_x4_trans(vi, smem_addr(swi + woff));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int e2 = 0; e2 < 2; ++e2) {
                const float2 a = to_float2<T>(vr[2 * h + e2]), c = to_float2<T>(vi[2 * h + e2]);
                const float war[2] = {a.x, a.y}, wai[2] = {c.x, c.y};
#pragma unroll
                for (int e1 = 0; e1 < 2; ++e1) {
                  float& tr = acc_t[0][j + h][2 * e2 + e1];
                  float& ti = acc_t[1][j + h][2 * e2 + e1];
                  const float ur_ = tr * war[e1] - ti * wai[e1];
                  const float ui_ = tr * wai[e1] + ti * war[e1];
                  tr = ur_;
                  ti = ui_;
                }
              }
            }
          }
        }
      }
      // stage 3: out[m][o] += u[m][r] U_o[o][r], u in three exact bf16
      // pieces a[16-rank step][re/im][piece][A register] (a C fragment
      // pair of t is an A fragment); the output tiles in a loop that is not
      // unrolled, the rank steps unrolled inside it, so the code stays small
      uint32_t a[RC / 16][2][3][4];
#pragma unroll
      for (int kk = 0; kk < RC / 16; ++kk)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int r4 = 0; r4 < 4; ++r4) {
            const float* c = acc_t[p][2 * kk + (r4 >> 1)] + 2 * (r4 & 1);
            split3(c[0], c[1], a[kk][p][0][r4], a[kk][p][1][r4], a[kk][p][2][r4]);
          }
      // the out tile goes to the slot's x/W area: every warp is past its reads
      const bool last = it.rc == nrc - 1;
      if (last) __syncthreads();
      T* sor = st;
      T* soi = st + OC * XP;
      if (wm < nm) {
#pragma unroll 1
        for (int j = 0; j < OC / 8; j += 2) {
          if (8 * j >= no) break;
          // [tile j + h][re/im][fragment]: the earlier rank chunks' sum
          float c[2][2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int p = 0; p < 2; ++p)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int o = 8 * (j + h) + 2 * t4 + (e & 1), m = wm + g + 8 * (e >> 1);
                c[h][p][e] = it.rc ? part[p * OC * P::PP + o * P::PP + m] : 0.f;
              }
#pragma unroll
          for (int kk = 0; kk < RC / 16; ++kk) {
            if (16 * kk < nr) {
              // matrices: channels of tile j at ranks 16 kk / + 8, then of tile j + 1
              const int uoff = (8 * (j + (lane >> 4)) + (lane & 7)) * UP + 16 * kk +
                               8 * ((lane >> 3) & 1);
              uint32_t br[4], bi[4];
              ldsm_x4(br, smem_addr(s_uor + uoff));
              ldsm_x4(bi, smem_addr(s_uoi + uoff));
              constexpr int NPIECE = std::is_same<T, __half>::value ? 2 : 1;
#pragma unroll
              for (int piece = 0; piece < NPIECE; ++piece) {
                uint32_t qr[4], qi[4];
#pragma unroll
                for (int r4 = 0; r4 < 4; ++r4) {
                  if constexpr (NPIECE == 1) {
                    qr[r4] = br[r4];
                    qi[r4] = bi[r4];
                  } else {   // fp16 U_o = hi + lo, both bf16
                    const float2 fr = to_float2<T>(br[r4]), fi = to_float2<T>(bi[r4]);
                    const uint32_t hr = pack2<__nv_bfloat16>(fr.x, fr.y);
                    const uint32_t hi = pack2<__nv_bfloat16>(fi.x, fi.y);
                    if (piece == 0) {
                      qr[r4] = hr;
                      qi[r4] = hi;
                    } else {
                      const float2 gr_ = bf16x2_to_float2(hr), gi_ = bf16x2_to_float2(hi);
                      qr[r4] = pack2<__nv_bfloat16>(fr.x - gr_.x, fr.y - gr_.y);
                      qi[r4] = pack2<__nv_bfloat16>(fi.x - gi_.x, fi.y - gi_.y);
                    }
                  }
                }
#pragma unroll
                for (int s3 = 0; s3 < 3; ++s3) {
                  // re += u_r U_or - u_i U_oi, im += u_r U_oi + u_i U_or
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    mma16816<__nv_bfloat16>(c[h][0], a[kk][0][s3], qr[2 * h], qr[2 * h + 1]);
                    mma16816<__nv_bfloat16>(c[h][1], a[kk][0][s3], qi[2 * h], qi[2 * h + 1]);
                  }
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    mma16816<__nv_bfloat16>(c[h][0], a[kk][1][s3], neg2(qi[2 * h]),
                                            neg2(qi[2 * h + 1]));
                    mma16816<__nv_bfloat16>(c[h][1], a[kk][1][s3], qr[2 * h], qr[2 * h + 1]);
                  }
                }
              }
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int p = 0; p < 2; ++p)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int o = 8 * (j + h) + 2 * t4 + (e & 1), m = wm + g + 8 * (e >> 1);
                if (last) {
                  (p ? soi : sor)[o * XP + m] = F::st(c[h][p][e]);
                } else {
                  part[p * OC * P::PP + o * P::PP + m] = c[h][p][e];
                }
              }
        }
      }
      if (!last) continue;
      __syncthreads();
      const size_t oo = (it.b * O + oc0) * M + it.m0;
      store_rows<T, NT>(outr + oo, M, sor, XP, no, nm, MT, um, tid);
      store_rows<T, NT>(outi + oo, M, soi, XP, no, nm, MT, um, tid);
    } else {
      // stage 1: thread (mq, nq) sums modes 4 mq.. x ranks 4 nq..
      float(&tr)[NJ][4] = acc_t[0];
      float(&ti)[NJ][4] = acc_t[1];
      for (int i = 0; i < nk; ++i) {
        const float4 a4 = *reinterpret_cast<const float4*>(sxr + i * XP + 4 * mq);
        const float4 c4 = *reinterpret_cast<const float4*>(sxi + i * XP + 4 * mq);
        const float4 p4 = *reinterpret_cast<const float4*>(s_uir + i * UP + 4 * nq);
        const float4 q4 = *reinterpret_cast<const float4*>(s_uii + i * UP + 4 * nq);
        const float xa[4] = {a4.x, a4.y, a4.z, a4.w}, xb[4] = {c4.x, c4.y, c4.z, c4.w};
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w}, pi[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            tr[k][c] = fmaf(xa[c], pr[k], tr[k][c]);
            tr[k][c] = fmaf(-xb[c], pi[k], tr[k][c]);
            ti[k][c] = fmaf(xa[c], pi[k], ti[k][c]);
            ti[k][c] = fmaf(xb[c], pr[k], ti[k][c]);
          }
      }
      if (it.ic < nic - 1) continue;

      // u = t W, then u through the slot's x/W area, [r][m]
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(swr + (4 * nq + k) * XP + 4 * mq);
        const float4 c4 = *reinterpret_cast<const float4*>(swi + (4 * nq + k) * XP + 4 * mq);
        const float vr[4] = {a4.x, a4.y, a4.z, a4.w}, vi[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float ur_ = tr[k][c] * vr[c] - ti[k][c] * vi[c];
          const float ui_ = tr[k][c] * vi[c] + ti[k][c] * vr[c];
          tr[k][c] = ur_;
          ti[k][c] = ui_;
        }
      }
      __syncthreads();
      T* sur = st;
      T* sui = st + RC * XP;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        *reinterpret_cast<float4*>(sur + (4 * nq + k) * XP + 4 * mq) =
            make_float4(tr[k][0], tr[k][1], tr[k][2], tr[k][3]);
        *reinterpret_cast<float4*>(sui + (4 * nq + k) * XP + 4 * mq) =
            make_float4(ti[k][0], ti[k][1], ti[k][2], ti[k][3]);
      }
      __syncthreads();
      // stage 3: thread (mq, nq) sums modes 4 mq.. x output channels 4 nq..
      float(&orr)[NJ][4] = acc_o[0];
      float(&oii)[NJ][4] = acc_o[1];
      for (int r = 0; r < nr; ++r) {
        const float4 a4 = *reinterpret_cast<const float4*>(sur + r * XP + 4 * mq);
        const float4 c4 = *reinterpret_cast<const float4*>(sui + r * XP + 4 * mq);
        const float4 p4 = *reinterpret_cast<const float4*>(s_uor + r * P::OTP + 4 * nq);
        const float4 q4 = *reinterpret_cast<const float4*>(s_uoi + r * P::OTP + 4 * nq);
        const float ua[4] = {a4.x, a4.y, a4.z, a4.w}, ub[4] = {c4.x, c4.y, c4.z, c4.w};
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w}, pi[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            orr[k][c] = fmaf(ua[c], pr[k], orr[k][c]);
            orr[k][c] = fmaf(-ub[c], pi[k], orr[k][c]);
            oii[k][c] = fmaf(ua[c], pi[k], oii[k][c]);
            oii[k][c] = fmaf(ub[c], pr[k], oii[k][c]);
          }
      }
      if (it.rc < nrc - 1) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int o = 4 * nq + k;
        if (o >= no) continue;
        const size_t off = (it.b * O + oc0 + o) * M + it.m0 + 4 * mq;
        if (um == 4) {
          if (4 * mq < nm) {
            const float* a = orr[k];
            const float* c = oii[k];
            *reinterpret_cast<float4*>(outr + off) = make_float4(a[0], a[1], a[2], a[3]);
            *reinterpret_cast<float4*>(outi + off) = make_float4(c[0], c[1], c[2], c[3]);
          }
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (4 * mq + c < nm) {
              outr[off + c] = orr[k][c];
              outi[off + c] = oii[k][c];
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// cp_bwd: persistent blocks of 256 threads, one an SM, each walking items
// (tile of MT consecutive modes, batch row b), b fastest.  An item's x and g
// tiles (the first 64-wide chunk of each) come in through a ring of two slots
// filled by cp.async, so the next item's loads are in flight while one is
// summed; where I, O and R are at most CH the factors U_i and U_o stay
// resident in shared memory, copied once a block.  For each 64-rank chunk:
//
//   phase 1  t[m][r] = sum_i x[i][m] U_i[i][r] and du[m][r] = sum_o g[o][m]
//            conj(U_o[o][r]) (warp tile 16 modes x NW1 rank tiles of 8),
//            then on the accumulators u = t W (W read from L2: shared
//            memory is full), dt = du conj(W) and row b's dW term du
//            conj(t), which goes to the workspace; u and dt go to shared
//            memory as three exact bf16 pieces each, [m][r], split once.
//   phase 2  dx^T[i][m] = sum_r conj(U_i[i][r]) dt[m][r] (warp tile 16
//            channels x NW2 mode tiles), stored at T a fragment pair at a
//            time (or, with several rank chunks, summed over them in the
//            block's slice of the workspace);
//            dU_i[i][r] += sum_m conj(x[i][m]) dt[m][r] and dU_o[o][r] +=
//            sum_m g[o][m] conj(u[m][r]) (warp tile 16 channels x 32 ranks).
//
// Every product is an mma.sync m16n8k16 with f32 sums.  An operand at T
// enters as it is stored (ldmatrix) where both are half (t and du in the
// half modes); an f32 operand (u and dt, read as their pieces; every operand
// in f32 mode) is split exactly into three bf16 pieces (split3), an fp16 one
// beside it into two,
// and the piece products whose orders add to at most 2 are summed (3 a term
// in bf16 mode, 5 in fp16, 6 in f32: what is left out is below f32's
// rounding of the product).  dU_i and dU_o stay in registers across the
// block's items where the widths fit one chunk (the path's I = O = R = 64),
// else in the block's slice of the workspace, added to by the one thread
// that owns each element, in item order; each block's partial and each
// batch row's dW term are then summed in a fixed order by
// cp_bwd_reduce_kernel (at the path's shape it reads 7.2 MB of dW terms and
// 8.7 MB of block partials, mostly from L2, where they were just written).
// Channels and ranks come in chunks of CH whose sums carry over, so there is
// no width or rank limit.
// ---------------------------------------------------------------------------
template <typename T>
struct BwdTile {
  static constexpr bool HALF = sizeof(T) == 2;
  static constexpr int NT = 256;                // threads
  static constexpr int MT = HALF ? 64 : 32;     // modes a tile
  static constexpr int CH = 64;                 // channels and ranks a chunk
  static constexpr int STAGES = 2;              // ring slots
  static constexpr int PAD = 16 / static_cast<int>(sizeof(T));
  static constexpr int XP = MT + PAD;           // x and g rows' pitch
  static constexpr int FP = CH + PAD;           // U_i and U_o rows' pitch
  static constexpr int PP = CH + 8;             // u and dt pieces' rows' pitch (bf16)
  static constexpr int TILE = CH * XP;          // an x or g plane
  static constexpr int SLOT = 4 * TILE;         // a slot's x and g, re/im
  static constexpr int FPLANE = CH * FP;
  static constexpr int PPLANE = MT * PP;        // a piece of u or dt, re or im
  static constexpr int WM = MT / 16;            // t, du: warps along the modes
  static constexpr int NW1 = CH / 8 / (8 / WM); // t, du: rank tiles a warp
  static constexpr int NW2 = MT / 16;           // dx^T: mode tiles a warp
  static constexpr long long SMEM =
      (static_cast<long long>(STAGES) * SLOT + 4 * FPLANE) * static_cast<long long>(sizeof(T)) +
      12LL * PPLANE * 2;
};

// a packed pair of T as two bf16 pieces, hi + lo, exactly (fp16's range and
// significand lie inside two bf16s')
template <typename T>
__device__ __forceinline__ void split2(uint32_t v, uint32_t& hi, uint32_t& lo) {
  const float2 f = to_float2<T>(v);
  hi = pack2<__nv_bfloat16>(f.x, f.y);
  const float2 h = bf16x2_to_float2(hi);
  lo = pack2<__nv_bfloat16>(f.x - h.x, f.y - h.y);
}

// A fragments (16 rows from r0, k from k0) or, B_ROLE, the B fragments of
// two n tiles (n from r0 and r0 + 8, k from k0; registers 0-1 the first
// tile's, 2-3 the second's) of a shared matrix stored [row][k] (KC) or
// [k][row], in NP pieces: 16-bit elements through ldmatrix (NP 1 as stored,
// 2 as bf16 pieces), f32 ones as pairs split into three bf16 pieces.
template <bool B_ROLE, bool KC, int NP, typename S>
__device__ __forceinline__ void ld_quad(uint32_t (&q)[NP][4], const S* base, int pitch, int r0,
                                        int k0, int lane) {
  if constexpr (sizeof(S) == 2) {
    static_assert(NP <= 2, "a 16-bit operand is one or two pieces");
    const int l7 = lane & 7, b3 = (lane >> 3) & 1, b4 = lane >> 4;
    const int dr = B_ROLE ? 8 * b4 : 8 * b3, dk = B_ROLE ? 8 * b3 : 8 * b4;
    uint32_t raw[4];
    if constexpr (KC) {
      ldsm_x4(raw, smem_addr(base + (r0 + l7 + dr) * pitch + k0 + dk));
    } else {
      ldsm_x4_trans(raw, smem_addr(base + (k0 + l7 + dk) * pitch + r0 + dr));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (NP == 1) {
        q[0][k] = raw[k];
      } else {
        split2<S>(raw[k], q[0][k], q[1][k]);
      }
    }
  } else {
    static_assert(NP == 3, "an f32 operand is three pieces");
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int dr = B_ROLE ? 8 * (k >> 1) : 8 * (k & 1), dk = B_ROLE ? 8 * (k & 1) : 8 * (k >> 1);
      const int row = r0 + g + dr, kk = k0 + 2 * t + dk;
      float2 v;
      if constexpr (KC) {
        v = *reinterpret_cast<const float2*>(base + row * pitch + kk);
      } else {
        v = make_float2(base[kk * pitch + row], base[(kk + 1) * pitch + row]);
      }
      split3(v.x, v.y, q[0][k], q[1][k], q[2][k]);
    }
  }
}

// c += a b over one k step and two n tiles, complex: CONJ 0 a b, 1 conj(a) b,
// 2 a conj(b); the piece products whose orders add to at most 2, each
// accumulator's products three mma apart
template <int PA, int PB, typename MM, int CONJ>
__device__ __forceinline__ void cmac(float (*cr)[4], float (*ci)[4], const uint32_t (&ar)[PA][4],
                                     const uint32_t (&ai)[PA][4], const uint32_t (&br)[PB][4],
                                     const uint32_t (&bi)[PB][4]) {
#pragma unroll
  for (int p = 0; p < PA; ++p)
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      if (p + q > 2) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) mma16816<MM>(cr[h], ar[p], br[q][2 * h], br[q][2 * h + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t b0 = bi[q][2 * h], b1 = bi[q][2 * h + 1];
        mma16816<MM>(ci[h], ar[p], CONJ == 2 ? neg2(b0) : b0, CONJ == 2 ? neg2(b1) : b1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t b0 = bi[q][2 * h], b1 = bi[q][2 * h + 1];
        mma16816<MM>(cr[h], ai[p], CONJ == 0 ? neg2(b0) : b0, CONJ == 0 ? neg2(b1) : b1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t b0 = br[q][2 * h], b1 = br[q][2 * h + 1];
        mma16816<MM>(ci[h], ai[p], CONJ == 1 ? neg2(b0) : b0, CONJ == 1 ? neg2(b1) : b1);
      }
    }
}

// a warp's 16 x 8 NW tile: c += sum over ksteps k steps of a b; la(k, ar,
// ai) loads the A pieces, lb(k, jj, br, bi) the B pieces of n tiles 2 jj and
// 2 jj + 1
template <int PA, int PB, typename MM, int CONJ, int NW, class LA, class LB>
__device__ __forceinline__ void cgemm(float (&cr)[NW][4], float (&ci)[NW][4], int ksteps,
                                      LA&& la, LB&& lb) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t ar[PA][4], ai[PA][4];
    la(ks, ar, ai);
#pragma unroll
    for (int jj = 0; jj < NW / 2; ++jj) {
      uint32_t br[PB][4], bi[PB][4];
      lb(ks, jj, br, bi);
      cmac<PA, PB, MM, CONJ>(cr + 2 * jj, ci + 2 * jj, ar, ai, br, bi);
    }
  }
}

template <int NW>
__device__ __forceinline__ void zero(float (&c)[NW][4]) {
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

template <int FMT>
__global__ void __launch_bounds__(BwdTile<typename Fmt<FMT>::T>::NT, 1)
cp_bwd_kernel(const typename Fmt<FMT>::T* __restrict__ xr,
              const typename Fmt<FMT>::T* __restrict__ xi,
              const typename Fmt<FMT>::T* __restrict__ uir,
              const typename Fmt<FMT>::T* __restrict__ uii,
              const typename Fmt<FMT>::T* __restrict__ uor,
              const typename Fmt<FMT>::T* __restrict__ uoi,
              const typename Fmt<FMT>::T* __restrict__ wr,
              const typename Fmt<FMT>::T* __restrict__ wi,
              const typename Fmt<FMT>::T* __restrict__ gr,
              const typename Fmt<FMT>::T* __restrict__ gi,
              typename Fmt<FMT>::T* __restrict__ dxr,
              typename Fmt<FMT>::T* __restrict__ dxi,
              float* __restrict__ dwp, float* __restrict__ part, float* __restrict__ dxp,
              int B, int I, int O, int R, int M, int onchip, int um, int ur, int pair) {
  using F = Fmt<FMT>;
  using T = typename F::T;
  using P = BwdTile<T>;
  constexpr bool HALF = P::HALF;
  constexpr int NT = P::NT, MT = P::MT, CH = P::CH, XP = P::XP, FP = P::FP, PP = P::PP;
  constexpr int NW1 = P::NW1, NW2 = P::NW2;
  // pieces of an operand at T in t and du (NPN, as stored in the half
  // modes) and beside a split f32 one (NP); the mma type of t and du
  constexpr int NPN = HALF ? 1 : 3;
  constexpr int NP = HALF ? (std::is_same<T, __half>::value ? 2 : 1) : 3;
  using MN = typename std::conditional<HALF, T, __nv_bfloat16>::type;
  using BF = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);
  T* const sui = ring + P::STAGES * P::SLOT;   // the U_i chunk [CH][FP], re then im
  T* const suo = sui + 2 * P::FPLANE;          // the U_o chunk
  // u and dt as three exact bf16 pieces each, [MT][PP]: plane (2 v + p) 3 +
  // piece, v 0 for u and 1 for dt, p 0 for re and 1 for im
  BF* const spc = reinterpret_cast<BF*>(suo + 2 * P::FPLANE);
  auto plane = [&](int v, int p) { return spc + (2 * v + p) * 3 * P::PPLANE; };
  // the B fragments of two n tiles in u's or dt's three pieces, from [n][k]
  // (KC: dx^T, k the ranks) or [k][n] (dU: k the modes)
  auto ld_pieces = [&](auto kc, uint32_t(&q)[3][4], const BF* pl, int r0, int k0, int ln) {
    constexpr bool KC = decltype(kc)::value;
#pragma unroll
    for (int piece = 0; piece < 3; ++piece) {
      uint32_t one[1][4];
      ld_quad<true, KC, 1>(one, pl + piece * P::PPLANE, PP, r0, k0, ln);
#pragma unroll
      for (int k = 0; k < 4; ++k) q[piece][k] = one[0][k];
    }
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int items = cdiv(M, MT) * B;
  const int nic = cdiv(I, CH), noc = cdiv(O, CH), nrc = cdiv(R, CH);
  const int mine = items > static_cast<int>(blockIdx.x)
                       ? (items - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const size_t IR = static_cast<size_t>(I) * R, OR = static_cast<size_t>(O) * R;
  float* const slice = part + blockIdx.x * 2 * (IR + OR);   // dU_i re, im, dU_o re, im
  float* const dxs = dxp + blockIdx.x * 2 * static_cast<size_t>(I) * MT;
  const size_t dplane = static_cast<size_t>(B) * R * M;
  // warp tiles: t, du [16 modes][8 NW1 ranks]; dx^T [16 channels][8 NW2
  // modes]; dU_i, dU_o [16 channels][32 ranks]
  const int w1m = 16 * (warp % P::WM), w1n = (warp / P::WM) * 8 * NW1;
  const int w2i = 16 * (warp % 4), w2m = (warp / 4) * 8 * NW2;
  const int w3i = 16 * (warp % 4), w3r = (warp / 4) * 32;

  auto item_of = [&](int k, int& m0, int& b) {
    const int q = blockIdx.x + k * gridDim.x;
    m0 = (q / B) * MT;
    b = q % B;
  };
  auto stage_x = [&](T* s, int b, int m0, int ic) {
    const int i0 = ic * CH;
    const size_t o = (static_cast<size_t>(b) * I + i0) * M + m0;
    copy_rows<T, NT>(s, XP, xr + o, M, I - i0, M - m0, CH, MT, um, tid);
    copy_rows<T, NT>(s + P::TILE, XP, xi + o, M, I - i0, M - m0, CH, MT, um, tid);
  };
  auto stage_g = [&](T* s, int b, int m0, int oc) {
    const int o0 = oc * CH;
    const size_t o = (static_cast<size_t>(b) * O + o0) * M + m0;
    copy_rows<T, NT>(s + 2 * P::TILE, XP, gr + o, M, O - o0, M - m0, CH, MT, um, tid);
    copy_rows<T, NT>(s + 3 * P::TILE, XP, gi + o, M, O - o0, M - m0, CH, MT, um, tid);
  };
  // the (c, rc) chunk of a factor [N][R] into [CH][FP]
  auto stage_f = [&](T* d, const T* fr, const T* fi, int N, int c, int rc) {
    const size_t o = static_cast<size_t>(c) * CH * R + rc * CH;
    copy_rows<T, NT>(d, FP, fr + o, R, N - c * CH, R - rc * CH, CH, CH, ur, tid);
    copy_rows<T, NT>(d + P::FPLANE, FP, fi + o, R, N - c * CH, R - rc * CH, CH, CH, ur, tid);
  };
  auto stage_item = [&](int k) {
    if (k < mine) {
      int m0, b;
      item_of(k, m0, b);
      T* s = ring + (k % P::STAGES) * P::SLOT;
      stage_x(s, b, m0, 0);
      stage_g(s, b, m0, 0);
    }
    cp_async_commit();
  };
  // a chunk that is not in shared memory yet, synchronously (wide factors)
  auto ensure = [&](int& cur, int want, auto&& copy) {
    if (cur == want) return;
    __syncthreads();   // every warp is done with what is there
    copy();
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    cur = want;
  };

  int cur_ui = -1, cur_uo = -1;
  if (onchip && mine > 0) {   // resident factors, once, in the first item's group
    stage_f(sui, uir, uii, I, 0, 0);
    stage_f(suo, uor, uoi, O, 0, 0);
    cur_ui = cur_uo = 0;
  }
  stage_item(0);

  // dU_i and dU_o of the warp's [16][32] tile, [n tile][fragment]
  float duir[4][4], duii[4][4], duor[4][4], duoi[4][4];
  zero(duir);
  zero(duii);
  zero(duor);
  zero(duoi);
  // the block's slice: add the tile at (c0, rc0) of dU_i (o = 0) or dU_o (o = 1)
  auto slice_io = [&](bool load, int o, int c0, int rc0, float (&cr)[4][4], float (&ci)[4][4]) {
    const int N = o ? O : I;
    float* pr = slice + (o ? 2 * IR : 0);
    float* pi = pr + (o ? OR : IR);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + w3i + g + 8 * (e >> 1), r = rc0 + w3r + 8 * j + 2 * t4 + (e & 1);
        if (c >= N || r >= R) continue;
        const size_t off = static_cast<size_t>(c) * R + r;
        if (load) {
          cr[j][e] = pr[off];
          ci[j][e] = pi[off];
        } else {
          pr[off] = cr[j][e];
          pi[off] = ci[j][e];
        }
      }
  };

  for (int k = 0; k < mine; ++k) {
    cp_async_wait<0>();   // item k has landed
    __syncthreads();      // and every thread is done with item k - 1
    stage_item(k + 1);
    int m0, b;
    item_of(k, m0, b);
    T* const s = ring + (k % P::STAGES) * P::SLOT;
    const T* const sxr = s;
    const T* const sxi = s + P::TILE;
    const T* const sgr = s + 2 * P::TILE;
    const T* const sgi = s + 3 * P::TILE;
    int cur_x = 0, cur_g = 0;   // the ring brought the first chunks
    const int nm = min(MT, M - m0), mk = cdiv(nm, 16);

    for (int rc = 0; rc < nrc; ++rc) {
      const int rc0 = rc * CH, nr = min(CH, R - rc0);
      // phase 1: t and du over the channel chunks
      float tr[NW1][4], ti[NW1][4], dr[NW1][4], di[NW1][4];
      zero(tr);
      zero(ti);
      zero(dr);
      zero(di);
      for (int ic = 0; ic < nic; ++ic) {
        ensure(cur_x, ic, [&] { stage_x(s, b, m0, ic); });
        ensure(cur_ui, ic * nrc + rc, [&] { stage_f(sui, uir, uii, I, ic, rc); });
        cgemm<NPN, NPN, MN, 0, NW1>(
            tr, ti, cdiv(min(CH, I - ic * CH), 16),
            [&](int kq, auto& ar, auto& ai) {
              ld_quad<false, false, NPN>(ar, sxr, XP, w1m, 16 * kq, lane);
              ld_quad<false, false, NPN>(ai, sxi, XP, w1m, 16 * kq, lane);
            },
            [&](int kq, int jj, auto& br, auto& bi) {
              ld_quad<true, false, NPN>(br, sui, FP, w1n + 16 * jj, 16 * kq, lane);
              ld_quad<true, false, NPN>(bi, sui + P::FPLANE, FP, w1n + 16 * jj, 16 * kq, lane);
            });
      }
      for (int oc = 0; oc < noc; ++oc) {
        ensure(cur_g, oc, [&] { stage_g(s, b, m0, oc); });
        ensure(cur_uo, oc * nrc + rc, [&] { stage_f(suo, uor, uoi, O, oc, rc); });
        cgemm<NPN, NPN, MN, 2, NW1>(
            dr, di, cdiv(min(CH, O - oc * CH), 16),
            [&](int kq, auto& ar, auto& ai) {
              ld_quad<false, false, NPN>(ar, sgr, XP, w1m, 16 * kq, lane);
              ld_quad<false, false, NPN>(ai, sgi, XP, w1m, 16 * kq, lane);
            },
            [&](int kq, int jj, auto& br, auto& bi) {
              ld_quad<true, false, NPN>(br, suo, FP, w1n + 16 * jj, 16 * kq, lane);
              ld_quad<true, false, NPN>(bi, suo + P::FPLANE, FP, w1n + 16 * jj, 16 * kq, lane);
            });
      }
      // u = t W and dt = du conj(W) in place; row b's dW term du conj(t)
      float* const dwpr = dwp + (static_cast<size_t>(b) * R + rc0) * M + m0;
      float* const dwpi = dwpr + dplane;
#pragma unroll
      for (int j = 0; j < NW1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = w1m + g + 8 * (e >> 1), r = w1n + 8 * j + 2 * t4 + (e & 1);
          const bool in = r < nr && m < nm;
          const size_t wo = static_cast<size_t>(rc0 + r) * M + m0 + m;
          const float vr = in ? F::ld(wr[wo]) : 0.f, vi = in ? F::ld(wi[wo]) : 0.f;
          const float a = tr[j][e], c = ti[j][e], p = dr[j][e], q = di[j][e];
          if (in) {
            dwpr[static_cast<size_t>(r) * M + m] = p * a + q * c;
            dwpi[static_cast<size_t>(r) * M + m] = q * a - p * c;
          }
          tr[j][e] = a * vr - c * vi;
          ti[j][e] = a * vi + c * vr;
          dr[j][e] = p * vr + q * vi;
          di[j][e] = q * vr - p * vi;
        }
      __syncthreads();   // every warp is done with the last u and dt
#pragma unroll
      for (int j = 0; j < NW1; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int off = (w1m + g + 8 * h) * PP + w1n + 8 * j + 2 * t4;
          auto put = [&](BF* d, float lo, float hi) {
            uint32_t q0, q1, q2;
            split3(lo, hi, q0, q1, q2);
            *reinterpret_cast<uint32_t*>(d + off) = q0;
            *reinterpret_cast<uint32_t*>(d + off + P::PPLANE) = q1;
            *reinterpret_cast<uint32_t*>(d + off + 2 * P::PPLANE) = q2;
          };
          put(plane(0, 0), tr[j][2 * h], tr[j][2 * h + 1]);
          put(plane(0, 1), ti[j][2 * h], ti[j][2 * h + 1]);
          put(plane(1, 0), dr[j][2 * h], dr[j][2 * h + 1]);
          put(plane(1, 1), di[j][2 * h], di[j][2 * h + 1]);
        }
      __syncthreads();

      // phase 2: dx and dU_i over the input chunks, dU_o over the output chunks
      for (int ic = 0; ic < nic; ++ic) {
        ensure(cur_x, ic, [&] { stage_x(s, b, m0, ic); });
        ensure(cur_ui, ic * nrc + rc, [&] { stage_f(sui, uir, uii, I, ic, rc); });
        const int i0 = ic * CH, ni = min(CH, I - i0);
        float xr_[NW2][4], xi_[NW2][4];
        zero(xr_);
        zero(xi_);
        if (rc > 0) {   // the earlier rank chunks' sum
#pragma unroll
          for (int j = 0; j < NW2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = w2i + g + 8 * (e >> 1), m = w2m + 8 * j + 2 * t4 + (e & 1);
              const size_t off = static_cast<size_t>(i0 + i) * MT + m;
              if (i < ni) {
                xr_[j][e] = dxs[off];
                xi_[j][e] = dxs[static_cast<size_t>(I) * MT + off];
              }
            }
        }
        cgemm<NP, 3, BF, 1, NW2>(
            xr_, xi_, cdiv(nr, 16),
            [&](int kq, auto& ar, auto& ai) {
              ld_quad<false, true, NP>(ar, sui, FP, w2i, 16 * kq, lane);
              ld_quad<false, true, NP>(ai, sui + P::FPLANE, FP, w2i, 16 * kq, lane);
            },
            [&](int kq, int jj, auto& br, auto& bi) {
              ld_pieces(std::true_type{}, br, plane(1, 0), w2m + 16 * jj, 16 * kq, lane);
              ld_pieces(std::true_type{}, bi, plane(1, 1), w2m + 16 * jj, 16 * kq, lane);
            });
        const bool last = rc == nrc - 1;
        // a fragment's pair (m, m + 1) in one store where rows allow it
        auto put = [&](T* d, size_t off, float a, float c, bool two) {
          if (pair) {
            if constexpr (HALF) {
              *reinterpret_cast<uint32_t*>(d + off) = pack2<T>(a, c);
            } else {
              *reinterpret_cast<float2*>(d + off) = make_float2(a, c);
            }
            return;
          }
          d[off] = F::st(a);
          if (two) d[off + 1] = F::st(c);
        };
#pragma unroll
        for (int j = 0; j < NW2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = w2i + g + 8 * h, m = w2m + 8 * j + 2 * t4;
            if (i >= ni || m >= nm) continue;
            const float ar = xr_[j][2 * h], cr = xr_[j][2 * h + 1];
            const float ai = xi_[j][2 * h], ci = xi_[j][2 * h + 1];
            if (last) {
              const size_t off = (static_cast<size_t>(b) * I + i0 + i) * M + m0 + m;
              put(dxr, off, ar, cr, m + 1 < nm);
              put(dxi, off, ai, ci, m + 1 < nm);
            } else {
              const size_t off = static_cast<size_t>(i0 + i) * MT + m;
              *reinterpret_cast<float2*>(dxs + off) = make_float2(ar, cr);
              *reinterpret_cast<float2*>(dxs + static_cast<size_t>(I) * MT + off) =
                  make_float2(ai, ci);
            }
          }
        if (!onchip) {
          if (k == 0) {
            zero(duir);
            zero(duii);
          } else {
            slice_io(true, 0, i0, rc0, duir, duii);
          }
        }
        cgemm<NP, 3, BF, 1, 4>(
            duir, duii, mk,
            [&](int kq, auto& ar, auto& ai) {
              ld_quad<false, true, NP>(ar, sxr, XP, w3i, 16 * kq, lane);
              ld_quad<false, true, NP>(ai, sxi, XP, w3i, 16 * kq, lane);
            },
            [&](int kq, int jj, auto& br, auto& bi) {
              ld_pieces(std::false_type{}, br, plane(1, 0), w3r + 16 * jj, 16 * kq, lane);
              ld_pieces(std::false_type{}, bi, plane(1, 1), w3r + 16 * jj, 16 * kq, lane);
            });
        if (!onchip) slice_io(false, 0, i0, rc0, duir, duii);
      }
      for (int oc = 0; oc < noc; ++oc) {
        ensure(cur_g, oc, [&] { stage_g(s, b, m0, oc); });
        const int o0 = oc * CH;
        if (!onchip) {
          if (k == 0) {
            zero(duor);
            zero(duoi);
          } else {
            slice_io(true, 1, o0, rc0, duor, duoi);
          }
        }
        cgemm<NP, 3, BF, 2, 4>(
            duor, duoi, mk,
            [&](int kq, auto& ar, auto& ai) {
              ld_quad<false, true, NP>(ar, sgr, XP, w3i, 16 * kq, lane);
              ld_quad<false, true, NP>(ai, sgi, XP, w3i, 16 * kq, lane);
            },
            [&](int kq, int jj, auto& br, auto& bi) {
              ld_pieces(std::false_type{}, br, plane(0, 0), w3r + 16 * jj, 16 * kq, lane);
              ld_pieces(std::false_type{}, bi, plane(0, 1), w3r + 16 * jj, 16 * kq, lane);
            });
        if (!onchip) slice_io(false, 1, o0, rc0, duor, duoi);
      }
    }
  }
  if (onchip && mine > 0) {
    slice_io(false, 0, 0, 0, duir, duii);
    slice_io(false, 1, 0, 0, duor, duoi);
  }
  cp_async_wait<0>();
}

// dU_i and dU_o: the blocks' partials summed in a fixed order (eight runs of
// consecutive blocks, each summed in block order by its own warp, then the
// eight run sums in run order), 32 elements a reduction block; dW: the batch
// rows' terms summed in batch order, an element a thread; stored at T.
constexpr int NTR = 256;          // threads a reduction block
constexpr int RUNS = NTR / 32;    // runs of blocks a dU element is summed in

template <int FMT>
__global__ void __launch_bounds__(NTR)
cp_bwd_reduce_kernel(const float* __restrict__ part, int nblk, const float* __restrict__ dwp,
                     int B, int I, int O, int R, int M,
                     typename Fmt<FMT>::T* __restrict__ duir,
                     typename Fmt<FMT>::T* __restrict__ duii,
                     typename Fmt<FMT>::T* __restrict__ duor,
                     typename Fmt<FMT>::T* __restrict__ duoi,
                     typename Fmt<FMT>::T* __restrict__ dwr,
                     typename Fmt<FMT>::T* __restrict__ dwi) {
  using F = Fmt<FMT>;
  __shared__ float runs[RUNS][32];
  const size_t ir = static_cast<size_t>(I) * R, orr = static_cast<size_t>(O) * R;
  const size_t per = 2 * (ir + orr), rm = static_cast<size_t>(R) * M;
  const size_t du_blocks = (per + 31) / 32;
  if (blockIdx.x < du_blocks) {
    const int lane = threadIdx.x % 32, run = threadIdx.x / 32;
    const size_t e = blockIdx.x * 32 + lane;
    const int len = (nblk + RUNS - 1) / RUNS, k0 = run * len, k1 = min(nblk, k0 + len);
    float s = 0.f;
    if (e < per) {
#pragma unroll 4
      for (int k = k0; k < k1; ++k) s += part[k * per + e];
    }
    runs[run][lane] = s;
    __syncthreads();
    if (run > 0 || e >= per) return;
    s = runs[0][lane];
#pragma unroll
    for (int r = 1; r < RUNS; ++r) s += runs[r][lane];
    if (e < ir) {
      duir[e] = F::st(s);
    } else if (e < 2 * ir) {
      duii[e - ir] = F::st(s);
    } else if (e < 2 * ir + orr) {
      duor[e - 2 * ir] = F::st(s);
    } else {
      duoi[e - 2 * ir - orr] = F::st(s);
    }
    return;
  }
  const size_t e = (blockIdx.x - du_blocks) * NTR + threadIdx.x;
  if (e >= 2 * rm) return;
  const size_t p = e / rm, idx = e % rm;
  const float* src = dwp + p * B * rm + idx;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += src[b * rm];
  (p ? dwi : dwr)[idx] = F::st(s);
}

// the widest copy, at most 16 bytes, of elements of T that divides a row of n
// elements and every pointer's alignment
template <typename T>
int unit_for(int n, std::initializer_list<const void*> ptrs) {
  for (int u = 16 / static_cast<int>(sizeof(T)); u > 1; u /= 2) {
    bool ok = n % u == 0;
    for (const void* p : ptrs) ok = ok && reinterpret_cast<uintptr_t>(p) % (u * sizeof(T)) == 0;
    if (ok) return u;
  }
  return 1;
}

template <int FMT>
int launch_fwd(const void* const* in, void* outr, void* outi, int B, int I, int O, int R,
               int M, int res, cudaStream_t stream) {
  using T = typename Fmt<FMT>::T;
  using P = FwdTile<T>;
  if (res && (I > P::RES || R > P::RC || O > P::OC)) return -2;
  // opt in to more than 48 KB of dynamic shared memory, and count the blocks
  // an SM holds under each plan, once, at the first launch (never inside a
  // CUDA graph capture, which follows a warm-up)
  static const cudaError_t opted = cudaFuncSetAttribute(
      cp_fwd_kernel<FMT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  struct Occupancy {
    cudaError_t err;
    int sms, per_sm[2];
  };
  static const Occupancy occ = [] {
    Occupancy o{cudaSuccess, 0, {0, 0}};
    int dev = 0;
    o.err = cudaGetDevice(&dev);
    if (o.err == cudaSuccess)
      o.err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
    for (int r = 0; r < 2 && o.err == cudaSuccess; ++r)
      o.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.per_sm[r], cp_fwd_kernel<FMT>,
                                                            P::NT, P::smem(r != 0));
    return o;
  }();
  if (occ.err != cudaSuccess) return static_cast<int>(occ.err);
  const int tiles = B * cdiv(M, P::MT);
  const int grid = std::min(tiles, std::max(1, occ.per_sm[res != 0]) * occ.sms);
  const T* const* a = reinterpret_cast<const T* const*>(in);
  const int um = unit_for<T>(M, {a[0], a[1], a[6], a[7], outr, outi});
  const int ur = unit_for<T>(R, {a[2], a[3], a[4], a[5]});
  cp_fwd_kernel<FMT><<<grid, P::NT, P::smem(res != 0), stream>>>(
      a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], static_cast<T*>(outr),
      static_cast<T*>(outi), B, I, O, R, M, res, um, ur);
  return static_cast<int>(cudaGetLastError());
}

// cp_bwd's grid: one block an SM (as many as fit), at most one an item; the
// attribute opt-in and the occupancy, once (never inside a CUDA graph
// capture, which follows a warm-up)
template <int FMT>
cudaError_t bwd_grid(int B, int M, int& grid) {
  using P = BwdTile<typename Fmt<FMT>::T>;
  struct Occupancy {
    cudaError_t err;
    int sms, per_sm;
  };
  static const Occupancy occ = [] {
    Occupancy o{cudaFuncSetAttribute(cp_bwd_kernel<FMT>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX),
                0, 0};
    int dev = 0;
    if (o.err == cudaSuccess) o.err = cudaGetDevice(&dev);
    if (o.err == cudaSuccess)
      o.err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
    if (o.err == cudaSuccess)
      o.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.per_sm, cp_bwd_kernel<FMT>, P::NT,
                                                            P::SMEM);
    return o;
  }();
  const long long items = 1LL * cdiv(M, P::MT) * B;
  grid = static_cast<int>(std::min<long long>(items, 1LL * std::max(1, occ.per_sm) * occ.sms));
  return occ.err;
}

// floats of f32 workspace: each batch row's dW terms, each block's dU_i and
// dU_o, and, with several rank chunks, each block's dx partial sums
template <int FMT>
long long bwd_workspace(int B, int I, int O, int R, int M, int grid) {
  using P = BwdTile<typename Fmt<FMT>::T>;
  const long long i = I, o = O, r = R;
  return 2LL * B * r * M + 2LL * grid * (i + o) * r +
         (cdiv(R, P::CH) > 1 ? 2LL * grid * i * P::MT : 0);
}

template <int FMT>
int launch_bwd(const void* const* in, void* const* out, float* ws, int B, int I, int O, int R,
               int M, int IC, int OC, int acc_smem, cudaStream_t stream) {
  using T = typename Fmt<FMT>::T;
  using P = BwdTile<T>;
  // the host's plan: chunks of CH channels, dU on chip where one chunk covers every width
  if (IC != std::min(I, P::CH) || OC != std::min(O, P::CH) ||
      acc_smem != (std::max(std::max(I, O), R) <= P::CH))
    return -2;
  int grid = 0;
  const cudaError_t err = bwd_grid<FMT>(B, M, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* const* a = reinterpret_cast<const T* const*>(in);
  T* const* d = reinterpret_cast<T* const*>(out);
  const int um = unit_for<T>(M, {a[0], a[1], a[6], a[7], a[8], a[9]});
  const int ur = unit_for<T>(R, {a[2], a[3], a[4], a[5]});
  // dx pairs (m, m + 1) in one store: even rows, and dx aligned to a pair
  const int pair = M % 2 == 0 && reinterpret_cast<uintptr_t>(d[0]) % (2 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(d[1]) % (2 * sizeof(T)) == 0;
  float* dwp = ws;
  float* part = dwp + 2LL * B * R * M;
  float* dxp = part + 2LL * grid * (static_cast<long long>(I) + O) * R;
  // out: dx re/im, dU_i re/im, dU_o re/im, dW re/im
  cp_bwd_kernel<FMT><<<grid, P::NT, P::SMEM, stream>>>(
      a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9], d[0], d[1], dwp, part, dxp, B,
      I, O, R, M, acc_smem, um, ur, pair);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const long long du = 2LL * (static_cast<long long>(I) + O) * R, dw = 2LL * R * M;
  const int blocks = static_cast<int>((du + 31) / 32 + (dw + NTR - 1) / NTR);
  cp_bwd_reduce_kernel<FMT><<<blocks, NTR, 0, stream>>>(
      part, grid, dwp, B, I, O, R, M, d[2], d[3], d[4], d[5], d[6], d[7]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes.  The launchers launch on `stream`,
// allocate nothing, and return cudaGetLastError(), -1 for an unknown
// format code or -2 for a plan the kernel does not take (the Python wrapper
// checks both first).  cp_bwd's IC and OC are the channels its 64-wide
// chunks cover (min(I, 64), min(O, 64)) and acc_smem says whether dU_i and
// dU_o stay on chip across a block's items (every width at most 64) or in
// its slice of the workspace; the workspace holds
// spectral_contract_cp_bwd_workspace floats.

// bytes of shared memory a cp_fwd block needs in format `fmt` with the factors
// resident (res) or streamed; -1 for an unknown format code
extern "C" long long spectral_contract_cp_fwd_smem(int fmt, int res) {
  switch (fmt) {
    case FMT_F32:
      return FwdTile<float>::smem(res != 0);
    case FMT_BF16:
      return FwdTile<__nv_bfloat16>::smem(res != 0);
    case FMT_F16:
      return FwdTile<__half>::smem(res != 0);
  }
  return -1;
}

// bytes of shared memory a cp_bwd block needs in format `fmt`; -1 for an
// unknown format code
extern "C" long long spectral_contract_cp_bwd_smem(int fmt) {
  switch (fmt) {
    case FMT_F32:
      return BwdTile<float>::SMEM;
    case FMT_BF16:
      return BwdTile<__nv_bfloat16>::SMEM;
    case FMT_F16:
      return BwdTile<__half>::SMEM;
  }
  return -1;
}

// floats of f32 workspace cp_bwd needs at these widths in format `fmt` on
// the current device (its grid follows the SM count); -1 for an unknown
// format code or a failed device query
extern "C" long long spectral_contract_cp_bwd_workspace(int B, int I, int O, int R, int M,
                                                        int fmt) {
  int grid = 0;
  switch (fmt) {
    case FMT_F32:
      return bwd_grid<FMT_F32>(B, M, grid) == cudaSuccess
                 ? bwd_workspace<FMT_F32>(B, I, O, R, M, grid) : -1;
    case FMT_BF16:
      return bwd_grid<FMT_BF16>(B, M, grid) == cudaSuccess
                 ? bwd_workspace<FMT_BF16>(B, I, O, R, M, grid) : -1;
    case FMT_F16:
      return bwd_grid<FMT_F16>(B, M, grid) == cudaSuccess
                 ? bwd_workspace<FMT_F16>(B, I, O, R, M, grid) : -1;
  }
  return -1;
}

extern "C" int spectral_contract_cp_fwd(
    const void* xr, const void* xi, const void* uir, const void* uii,
    const void* uor, const void* uoi, const void* wr, const void* wi, void* outr,
    void* outi, int B, int I, int O, int R, int M, int res, int fmt, void* stream) {
  const void* in[8] = {xr, xi, uir, uii, uor, uoi, wr, wi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case FMT_F32:
      return launch_fwd<FMT_F32>(in, outr, outi, B, I, O, R, M, res, s);
    case FMT_BF16:
      return launch_fwd<FMT_BF16>(in, outr, outi, B, I, O, R, M, res, s);
    case FMT_F16:
      return launch_fwd<FMT_F16>(in, outr, outi, B, I, O, R, M, res, s);
  }
  return -1;
}

extern "C" int spectral_contract_cp_bwd(
    const void* xr, const void* xi, const void* uir, const void* uii,
    const void* uor, const void* uoi, const void* wr, const void* wi,
    const void* gr, const void* gi, void* dxr, void* dxi, void* duir, void* duii,
    void* duor, void* duoi, void* dwr, void* dwi, void* workspace, int B, int I,
    int O, int R, int M, int IC, int OC, int acc_smem, int fmt, void* stream) {
  const void* in[10] = {xr, xi, uir, uii, uor, uoi, wr, wi, gr, gi};
  void* out[8] = {dxr, dxi, duir, duii, duor, duoi, dwr, dwi};
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case FMT_F32:
      return launch_bwd<FMT_F32>(in, out, ws, B, I, O, R, M, IC, OC, acc_smem, s);
    case FMT_BF16:
      return launch_bwd<FMT_BF16>(in, out, ws, B, I, O, R, M, IC, OC, acc_smem, s);
    case FMT_F16:
      return launch_bwd<FMT_F16>(in, out, ws, B, I, O, R, M, IC, OC, acc_smem, s);
  }
  return -1;
}

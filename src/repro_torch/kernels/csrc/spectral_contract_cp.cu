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
// bytes.  cp_bwd's products of the f32 t, u, du or dt (u, dt, dx, dU_i,
// dU_o, dW) take the CUDA cores: 21.9 us, bound by operations.
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
// cp_bwd's design, simply: f32 FMAs on the CUDA cores, with the rank factors
// staged in shared memory as f32, so the inner loops read shared memory
// only.  One block of 512 threads per mode tile of 16 stages its x and g
// tiles as f32, looping over the batch so that dW of its modes is summed
// inside the block; dU_i and dU_o of the tile are summed across the batch and
// written as per-tile f32 partials, which a second kernel sums in tile order.
// Only its rank-sized tiles stay resident in shared memory (u, dt and dW,
// [R][16 or 17], 100 KB at R = 256).  The x (or g) tile and the factors are
// staged in chunks of IC input and OC output channels, which the host picks
// (`cp_bwd_plan` in kernels/spectral_contract.py) so that the block fits in
// 227 KB; a partial sum over the input channels waits in the t (or du) tile
// between chunks, so every sum keeps the order of one chunk and a chunked
// launch is bit-identical to an unchunked one.  dU_i and dU_o of its tile
// stay in shared memory where they fit and in its own slice of the f32
// workspace otherwise, each element added to once per batch row by one
// thread, in batch order either way.  At I = O = R one chunk covers both
// channel axes up to 101 channels (dU_i and dU_o in shared memory up to 75),
// as at the path's 64; cp_bwd takes R <= 558, where the resident rank tiles
// and a one-channel chunk still fit.
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

constexpr int NT = 256;       // threads per cp_bwd reduction block
constexpr int NTB = 512;      // threads per cp_bwd block
constexpr int TMB = 16;       // modes per cp_bwd block
constexpr int TP = TMB + 1;   // padded row of cp_bwd's [R][TMB] tiles
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

__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }
// chunks of c covering n channels; one (empty) chunk for none
__host__ __device__ inline int n_chunks(int n, int c) { return n > 0 ? (n + c - 1) / c : 1; }

long long bwd_smem_floats(int I, int O, int R, int IC, int OC, int acc_smem) {
  const long long i = I, o = O, r = R, ic = IC, oc = OC;
  // u and dt [R][TP], dW [R][TMB], the x and g chunks [IC|OC][TMB], the
  // U_i and U_o chunks as f32 [IC|OC][R], and, where they fit, dU_i [I][R]
  // and dU_o [O][R], re/im each
  return 2LL * (2 * r * TP + r * TMB + ic * TMB + oc * TMB + ic * r + oc * r +
                (acc_smem ? i * r + o * r : 0));
}

int n_tiles(int M, int tm) { return (M + tm - 1) / tm; }

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
// where that is under 4 bytes, plain loads.
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
  const int upr = nc / unit;
  for (int e = tid; e < nr * upr; e += NTH) {
    const int r = e / upr, c = (e % upr) * unit;
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
// cp_bwd: block (mode tile m0..m0+TMB), every batch row.  Per row: t over the
// input-channel chunks, du over the output-channel chunks (each partial sum
// waiting in its rank tile), then u, dt and dW per (r, m); then dx and dU_i
// over the input chunks and dU_o over the output chunks.  Without CHUNKED one
// chunk covers each channel axis: the factors are staged once, x and g once
// per row, and t and du are summed in registers in one pass per (r, m).
// ---------------------------------------------------------------------------
template <int FMT, bool CHUNKED>
__global__ void __launch_bounds__(NTB)
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
              typename Fmt<FMT>::T* __restrict__ dwr,
              typename Fmt<FMT>::T* __restrict__ dwi,
              float* __restrict__ part,
              int B, int I, int O, int R, int M, int IC, int OC, int acc_smem) {
  using F = Fmt<FMT>;
  extern __shared__ __align__(16) float smem[];
  float* sur = smem;              // t, then u: [R][TP]
  float* sui = sur + R * TP;
  float* str = sui + R * TP;      // du, then dt: [R][TP]
  float* sti = str + R * TP;
  float* swr = sti + R * TP;      // dW, [R][TMB]
  float* swi = swr + R * TMB;
  float* sxr = swi + R * TMB;     // the x chunk, [IC][TMB]
  float* sxi = sxr + IC * TMB;
  float* sgr = sxi + IC * TMB;    // the g chunk, [OC][TMB]
  float* sgi = sgr + OC * TMB;
  float* suir = sgi + OC * TMB;   // the U_i chunk as f32, [IC][R]
  float* suii = suir + IC * R;
  float* suor = suii + IC * R;    // the U_o chunk as f32, [OC][R]
  float* suoi = suor + OC * R;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TMB;
  const int nic = CHUNKED ? n_chunks(I, IC) : 1, noc = CHUNKED ? n_chunks(O, OC) : 1;
  // dU_i [I][R] and dU_o [O][R], re/im: in shared memory where they fit,
  // else this tile's slice of the workspace, which the partials go to anyway
  const size_t ir = static_cast<size_t>(I) * R, orr = static_cast<size_t>(O) * R;
  float* p = part + blockIdx.x * 2 * (ir + orr);
  float* sar = acc_smem ? suoi + OC * R : p;
  float* sai = sar + ir;
  float* sbr = sai + ir;
  float* sbi = sbr + orr;

  for (int t = tid; t < R * TMB; t += NTB) {
    swr[t] = 0.f;
    swi[t] = 0.f;
  }
  for (size_t t = tid; t < 2 * (ir + orr); t += NTB) sar[t] = 0.f;

  // the x (and U_i) or g (and U_o) chunk of batch row b as f32, zero past M
  auto stage = [&](size_t b, int n0, int n, int N, const typename F::T* ar,
                   const typename F::T* ai, const typename F::T* fr,
                   const typename F::T* fi, float* sr, float* si, float* ur, float* ui,
                   bool factors) {
    for (int t = tid; t < n * TMB; t += NTB) {
      const int k = n0 + t / TMB, m = m0 + t % TMB;
      float vr = 0.f, vi = 0.f;
      if (m < M) {
        const size_t off = (b * N + k) * M + m;
        vr = F::ld(ar[off]);
        vi = F::ld(ai[off]);
      }
      sr[t] = vr;
      si[t] = vi;
    }
    if (factors) {
      for (int t = tid; t < n * R; t += NTB) {
        ur[t] = F::ld(fr[static_cast<size_t>(n0) * R + t]);
        ui[t] = F::ld(fi[static_cast<size_t>(n0) * R + t]);
      }
    }
  };

  // t[r][m] = sum_i x[i][m] U_i[i][r] over input channels i0..i0+ni,
  // continuing the partial sum (tr, ti)
  auto project = [&](int t, int ni, float& tr, float& ti) {
    const int r = t / TMB, mm = t % TMB;
    for (int i = 0; i < ni; ++i) {
      const float ar = sxr[i * TMB + mm], ai = sxi[i * TMB + mm];
      const float br = suir[i * R + r], bi = suii[i * R + r];
      tr = fmaf(ar, br, tr);
      tr = fmaf(-ai, bi, tr);
      ti = fmaf(ar, bi, ti);
      ti = fmaf(ai, br, ti);
    }
  };
  // du[r][m] = sum_o g[o][m] conj(U_o[o][r]) over output channels o0..o0+no
  auto pullback = [&](int t, int no, float& dur, float& dui) {
    const int r = t / TMB, mm = t % TMB;
    for (int o = 0; o < no; ++o) {
      const float ar = sgr[o * TMB + mm], ai = sgi[o * TMB + mm];
      const float br = suor[o * R + r], bi = suoi[o * R + r];
      dur = fmaf(ar, br, dur);
      dur = fmaf(ai, bi, dur);
      dui = fmaf(ai, br, dui);
      dui = fmaf(-ar, bi, dui);
    }
  };
  // per (r, m): u = t W, dt = du conj(W); dW accumulates du conj(t) over rows
  auto finish = [&](int t, float tr, float ti, float dur, float dui) {
    const int r = t / TMB, mm = t % TMB, m = m0 + mm;
    float vr = 0.f, vi = 0.f;
    if (m < M) {
      vr = F::ld(wr[static_cast<size_t>(r) * M + m]);
      vi = F::ld(wi[static_cast<size_t>(r) * M + m]);
    }
    sur[r * TP + mm] = tr * vr - ti * vi;
    sui[r * TP + mm] = tr * vi + ti * vr;
    str[r * TP + mm] = dur * vr + dui * vi;     // du * conj(W)
    sti[r * TP + mm] = dui * vr - dur * vi;
    swr[t] += dur * tr + dui * ti;              // du * conj(t)
    swi[t] += dui * tr - dur * ti;
  };

  for (size_t b = 0; b < static_cast<size_t>(B); ++b) {
    if (!CHUNKED) {
      stage(b, 0, I, I, xr, xi, uir, uii, sxr, sxi, suir, suii, b == 0);
      stage(b, 0, O, O, gr, gi, uor, uoi, sgr, sgi, suor, suoi, b == 0);
      __syncthreads();
      for (int t = tid; t < R * TMB; t += NTB) {
        float tr = 0.f, ti = 0.f, dur = 0.f, dui = 0.f;
        project(t, I, tr, ti);
        pullback(t, O, dur, dui);
        finish(t, tr, ti, dur, dui);
      }
      __syncthreads();
    } else {
      for (int c = 0; c < nic; ++c) {
        const int i0 = c * IC, ni = min(IC, I - i0);
        stage(b, i0, ni, I, xr, xi, uir, uii, sxr, sxi, suir, suii, true);
        __syncthreads();
        for (int t = tid; t < R * TMB; t += NTB) {
          const int r = t / TMB, mm = t % TMB;
          float tr = c > 0 ? sur[r * TP + mm] : 0.f, ti = c > 0 ? sui[r * TP + mm] : 0.f;
          project(t, ni, tr, ti);
          sur[r * TP + mm] = tr;
          sui[r * TP + mm] = ti;
        }
        __syncthreads();
      }
      for (int c = 0; c < noc; ++c) {
        const int o0 = c * OC, no = min(OC, O - o0);
        stage(b, o0, no, O, gr, gi, uor, uoi, sgr, sgi, suor, suoi, true);
        __syncthreads();
        for (int t = tid; t < R * TMB; t += NTB) {
          const int r = t / TMB, mm = t % TMB;
          float dur = c > 0 ? str[r * TP + mm] : 0.f, dui = c > 0 ? sti[r * TP + mm] : 0.f;
          pullback(t, no, dur, dui);
          str[r * TP + mm] = dur;
          sti[r * TP + mm] = dui;
        }
        __syncthreads();
      }
      for (int t = tid; t < R * TMB; t += NTB) {
        const int r = t / TMB, mm = t % TMB;
        finish(t, sur[r * TP + mm], sui[r * TP + mm], str[r * TP + mm], sti[r * TP + mm]);
      }
      __syncthreads();
    }

    for (int c = 0; c < nic; ++c) {
      const int i0 = c * IC, ni = CHUNKED ? min(IC, I - i0) : I;
      if (CHUNKED && nic > 1) {
        stage(b, i0, ni, I, xr, xi, uir, uii, sxr, sxi, suir, suii, true);
        __syncthreads();
      }
      // dx[b][i][m] = sum_r dt[r][m] conj(U_i[i][r])
      for (int t = tid; t < ni * TMB; t += NTB) {
        const int i = t / TMB, mm = t % TMB, m = m0 + mm;
        if (m >= M) continue;
        float accr = 0.f, acci = 0.f;
        for (int r = 0; r < R; ++r) {
          const float ar = str[r * TP + mm], ai = sti[r * TP + mm];
          const float br = suir[i * R + r], bi = suii[i * R + r];
          accr = fmaf(ar, br, accr);
          accr = fmaf(ai, bi, accr);
          acci = fmaf(ai, br, acci);
          acci = fmaf(-ar, bi, acci);
        }
        const size_t off = (b * I + i0 + i) * M + m;
        dxr[off] = F::st(accr);
        dxi[off] = F::st(acci);
      }
      // dU_i[i][r] += sum_m conj(x[i][m]) dt[r][m]
      for (int t = tid; t < ni * R; t += NTB) {
        const int i = t / R, r = t % R;
        float accr = 0.f, acci = 0.f;
        for (int mm = 0; mm < TMB; ++mm) {
          const float ar = sxr[i * TMB + mm], ai = sxi[i * TMB + mm];
          const float br = str[r * TP + mm], bi = sti[r * TP + mm];
          accr = fmaf(ar, br, accr);
          accr = fmaf(ai, bi, accr);
          acci = fmaf(ar, bi, acci);
          acci = fmaf(-ai, br, acci);
        }
        sar[static_cast<size_t>(i0) * R + t] += accr;
        sai[static_cast<size_t>(i0) * R + t] += acci;
      }
      if (CHUNKED) __syncthreads();
    }
    // dU_o[o][r] += sum_m g[o][m] conj(u[r][m])
    for (int c = 0; c < noc; ++c) {
      const int o0 = c * OC, no = CHUNKED ? min(OC, O - o0) : O;
      if (CHUNKED && noc > 1) {
        stage(b, o0, no, O, gr, gi, uor, uoi, sgr, sgi, suor, suoi, false);
        __syncthreads();
      }
      for (int t = tid; t < no * R; t += NTB) {
        const int o = t / R, r = t % R;
        float accr = 0.f, acci = 0.f;
        for (int mm = 0; mm < TMB; ++mm) {
          const float ar = sgr[o * TMB + mm], ai = sgi[o * TMB + mm];
          const float br = sur[r * TP + mm], bi = sui[r * TP + mm];
          accr = fmaf(ar, br, accr);
          accr = fmaf(ai, bi, accr);
          acci = fmaf(ai, br, acci);
          acci = fmaf(-ar, bi, acci);
        }
        sbr[static_cast<size_t>(o0) * R + t] += accr;
        sbi[static_cast<size_t>(o0) * R + t] += acci;
      }
      if (CHUNKED) __syncthreads();
    }
    if (!CHUNKED) __syncthreads();
  }

  // dW of the tile's modes, summed over the batch
  for (int t = tid; t < R * TMB; t += NTB) {
    const int r = t / TMB, m = m0 + t % TMB;
    if (m < M) {
      dwr[static_cast<size_t>(r) * M + m] = F::st(swr[t]);
      dwi[static_cast<size_t>(r) * M + m] = F::st(swi[t]);
    }
  }
  // this tile's f32 partials of dU_i and dU_o: [dUi re | dUi im | dUo re | dUo im]
  if (acc_smem) {
    for (size_t t = tid; t < 2 * (ir + orr); t += NTB) p[t] = sar[t];
  }
}

// dU_i and dU_o: the per-tile partials summed in tile order, stored at T.
template <int FMT>
__global__ void __launch_bounds__(NT)
cp_bwd_reduce_kernel(const float* __restrict__ part, int tiles, int I, int O, int R,
                     typename Fmt<FMT>::T* __restrict__ duir,
                     typename Fmt<FMT>::T* __restrict__ duii,
                     typename Fmt<FMT>::T* __restrict__ duor,
                     typename Fmt<FMT>::T* __restrict__ duoi) {
  using F = Fmt<FMT>;
  const size_t ir = static_cast<size_t>(I) * R, orr = static_cast<size_t>(O) * R;
  const size_t per = 2 * (ir + orr);
  const size_t e = static_cast<size_t>(blockIdx.x) * NT + threadIdx.x;
  if (e >= per) return;
  float s = 0.f;
  for (int k = 0; k < tiles; ++k) s += part[k * per + e];
  if (e < ir) {
    duir[e] = F::st(s);
  } else if (e < 2 * ir) {
    duii[e - ir] = F::st(s);
  } else if (e < 2 * ir + orr) {
    duor[e - 2 * ir] = F::st(s);
  } else {
    duoi[e - 2 * ir - orr] = F::st(s);
  }
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

template <int FMT>
int launch_bwd(const void* const* in, void* const* out, float* part, int B, int I,
               int O, int R, int M, int IC, int OC, int acc_smem, cudaStream_t stream) {
  using T = typename Fmt<FMT>::T;
  const size_t smem = bwd_smem_floats(I, O, R, IC, OC, acc_smem) * sizeof(float);
  if (smem > SMEM_MAX || IC < 1 || OC < 1) return -2;
  static const cudaError_t opted[2] = {
      cudaFuncSetAttribute(cp_bwd_kernel<FMT, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX),
      cudaFuncSetAttribute(cp_bwd_kernel<FMT, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX)};
  if (opted[0] != cudaSuccess) return static_cast<int>(opted[0]);
  if (opted[1] != cudaSuccess) return static_cast<int>(opted[1]);
  const int tiles = n_tiles(M, TMB);
  const T* const* a = reinterpret_cast<const T* const*>(in);
  T* const* d = reinterpret_cast<T* const*>(out);
  auto* kernel = n_chunks(I, IC) > 1 || n_chunks(O, OC) > 1 ? cp_bwd_kernel<FMT, true>
                                                            : cp_bwd_kernel<FMT, false>;
  // out: dx re/im, dU_i re/im, dU_o re/im, dW re/im
  kernel<<<tiles, NTB, smem, stream>>>(
      a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9], d[0], d[1], d[6],
      d[7], part, B, I, O, R, M, IC, OC, acc_smem);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const size_t per = 2 * (static_cast<size_t>(I) * R + static_cast<size_t>(O) * R);
  const int blocks = static_cast<int>((per + NT - 1) / NT);
  cp_bwd_reduce_kernel<FMT><<<blocks, NT, 0, stream>>>(part, tiles, I, O, R, d[2], d[3],
                                                        d[4], d[5]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes.  The launchers launch on `stream`,
// allocate nothing, and return cudaGetLastError(), -1 for an unknown
// format code or -2 for a channel plan whose working set exceeds a block's
// shared memory (the Python wrapper checks both first).  IC and OC are the
// channel chunks of the host's plan; acc_smem says whether cp_bwd keeps dU_i
// and dU_o in shared memory.

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

extern "C" long long spectral_contract_cp_bwd_smem(int I, int O, int R, int IC, int OC,
                                                   int acc_smem) {
  return bwd_smem_floats(I, O, R, IC, OC, acc_smem) * static_cast<long long>(sizeof(float));
}

// floats of f32 scratch cp_bwd needs: per mode tile, dU_i and dU_o re/im
extern "C" long long spectral_contract_cp_bwd_workspace(int I, int O, int R, int M) {
  return static_cast<long long>(n_tiles(M, TMB)) * 2LL *
         (static_cast<long long>(I) * R + static_cast<long long>(O) * R);
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
  float* part = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case FMT_F32:
      return launch_bwd<FMT_F32>(in, out, part, B, I, O, R, M, IC, OC, acc_smem, s);
    case FMT_BF16:
      return launch_bwd<FMT_BF16>(in, out, part, B, I, O, R, M, IC, OC, acc_smem, s);
    case FMT_F16:
      return launch_bwd<FMT_F16>(in, out, part, B, I, O, R, M, IC, OC, acc_smem, s);
  }
  return -1;
}

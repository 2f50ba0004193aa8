// The streaming dense contraction shared by dense_fwd (spectral_contract.cu)
// and dense_bwd_x (spectral_contract_bwd.cu), for Hopper (sm_90a).
//
// Both sum, for every retained Fourier mode m, a data operand d (B, K, M)
// against the f32 weight w (I, O, M) over one of w's channel axes:
//
//     dense_fwd:    out[b,o,m] = sum_i x[b,i,m] * w[i,o,m]          (N = O, K = I)
//     dense_bwd_x:  dx[b,i,m]  = sum_o g[b,o,m] * conj(w[i,o,m])    (N = I, K = O, CONJ)
//
// in split-real form; they differ only in which of w's axes is summed and in
// the signs of the imaginary terms.  CAST rounds every operand onto the bf16
// or fp16 grid (round to nearest even) before use; sums are f32.  d is f32
// (x) or stored at D (g: f32, bf16 or fp16); the output is stored at OUT.
//
// What bounds them.  At the paths' shape (B=8, I=O=64, M=1024) each moves
// ~40 MB, of which the f32 weight is 33.6 MB: 11.9 us at 3.35 TB/s, against
// 4.0 us for their 268 MFLOP on the f32 CUDA cores.  They are memory-bound.
//
// What the design does about it: it streams the weight.  Persistent blocks
// of NT threads, one an SM, walk (TMD-mode, TN-channel, BT-batch-row) tiles,
// channel tiles fastest, so the blocks in flight share d in L2.  A tile's
// summed channels come KCH at a time through a ring of STAGES slots filled by
// cp.async, 16 bytes a copy: the weight's [KCH][TN][TMD] slab and d's
// [KCH][BT][TMD] slab at d's own width, so two slots of loads (~135 KB an SM)
// are in flight while one is summed, across tiles too.  Each weight element
// is read from device memory once (for B <= BT).  Each thread copies its
// units of a slot from offsets set once a tile and rounds them onto CAST in
// place once they land, before the slot's barrier, two values a conversion,
// so every element is rounded once.  A half d is widened instead, by the
// thread that copied it, into one of two f32 planes (the slot being summed
// and the next), rounded there only where CAST is the other half format:
// never in 16-bit storage, since an fp16 g near 65504 rounds to a bf16 65536.
// Thread (n, mg, bh) owns channel n, modes 4 mg.. and batch rows 4 bh..: per
// summed channel, two float4 reads of w and eight broadcast float4 reads of
// d feed 64 FMAs, and the sums go out as 16- or 8-byte stores along m,
// straight from registers.  Every output sums k ascending from 0 with the
// same FMAs a term as the kernels before this design, so its result is
// bit-identical to theirs.  Batches wider than BT run as more tiles and
// re-read the weight once per BT rows.  Rows off 16 bytes (M not a multiple
// of a copy's modes, or an operand off its alignment) are staged element by
// element, rounded as they are stored; ragged channel and batch edges are
// zero-filled.  An empty sum (K = 0) is stored as zeros by the launcher.
#pragma once

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_sync.cuh"

namespace dense_stream {

using namespace mma_sync;

enum { FMT_F32 = 0, FMT_BF16 = 1, FMT_F16 = 2 };

template <int FMT>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (FMT == FMT_BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else if constexpr (FMT == FMT_F16) {
    return __half2float(__float2half_rn(v));
  } else {
    return v;
  }
}

// two values rounded as round_to rounds them, with one packed conversion
template <int FMT>
__device__ __forceinline__ float2 round2(float a, float b) {
  if constexpr (FMT == FMT_BF16) {
    return __bfloat1622float2(__floats2bfloat162_rn(a, b));
  } else if constexpr (FMT == FMT_F16) {
    return __half22float2(__floats2half2_rn(a, b));
  } else {
    return make_float2(a, b);
  }
}

// a format's element type, read into f32 and stored from it (round to nearest even)
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

constexpr int NT = 256;        // threads a block: 16 four-mode groups x 8 channels x 2
constexpr int TMD = 64;        // modes a tile
constexpr int TN = 8;          // kept channels a tile (dense_fwd: o; dense_bwd_x: i)
constexpr int BT = 8;          // batch rows a tile, held in registers
constexpr int KCH = 8;         // summed channels a ring slot
constexpr int STAGES = 3;      // ring slots
constexpr int WP = TMD + 4;    // weight rows' pitch (floats): conflict-free float4 reads
constexpr int W_PLANE = KCH * TN * WP;    // floats of a slot's weight, re or im
constexpr int D_PLANE = KCH * BT * TMD;   // elements of a slot's d, re or im

// The ring's layout for a d of element type T: each slot holds the weight's
// two planes, then d's two at T; a half d is summed from two f32 planes
// after the slots, alternating by slot.
template <typename T>
struct Ring {
  static constexpr int UE = 16 / static_cast<int>(sizeof(T));   // d elements a copy
  static constexpr int UPR = TMD / UE;         // copies a d row
  static constexpr int KS = NT / (UPR * BT);   // summed-channel step of a thread's d copies
  static constexpr int DJ = 2 * KCH / KS;      // d copies a thread makes a slot, re and im
  static constexpr bool WIDEN = sizeof(T) == 2;
  static constexpr int W_BYTES = 2 * W_PLANE * 4;
  static constexpr int STAGE = W_BYTES + 2 * D_PLANE * static_cast<int>(sizeof(T));
  // 198 KB with an f32 d, 214 KB with a half one
  static constexpr int SMEM = STAGES * STAGE + (WIDEN ? 2 * 2 * D_PLANE * 4 : 0);
  static_assert(NT % (UPR * BT) == 0 && KCH % KS == 0, "a thread copies whole d units");
};

template <int CAST, int D, int OUT, bool CONJ>
__device__ __forceinline__ void contract_stream(
    const typename Fmt<D>::T* __restrict__ dr, const typename Fmt<D>::T* __restrict__ di,
    const float* __restrict__ wr, const float* __restrict__ wi,
    typename Fmt<OUT>::T* __restrict__ outr, typename Fmt<OUT>::T* __restrict__ outi,
    int B, int N, int K, int M, int vec, int vecd) {
  using T = typename Fmt<D>::T;
  using S = typename Fmt<OUT>::T;
  using R = Ring<T>;
  constexpr bool ROUND = CAST != FMT_F32;
  constexpr int UPR = TMD / 4;   // 4-mode weight copies a row
  static_assert(NT == 2 * UPR * TN && TN == BT && KCH % 2 == 0,
                "a thread copies KCH units of the weight a slot");
  constexpr int HJ = KCH / 2;     // a thread's weight units in each plane
  constexpr int HD = R::DJ / 2;   // its d units in each plane
  extern __shared__ __align__(16) unsigned char stream_smem[];

  const int tid = threadIdx.x;
  // summing: channel n, modes 4 mg.., batch rows 4 bh..
  const int n = tid % TN, mg = (tid / TN) % UPR, bh = tid / (TN * UPR);
  // copying: unit cu of weight row r4 (a kept channel) of summed channels kb,
  // kb + 2, ..., and unit du of d row dq (a batch row) of summed channels dk,
  // dk + KS, ..., re and im
  const int cu = tid % UPR, r4 = (tid / UPR) % TN, kb = tid / (UPR * TN);
  const int du = tid % R::UPR, dq = (tid / R::UPR) % BT, dk = tid / (R::UPR * BT);
  const int nmt = (M + TMD - 1) / TMD, nnt = (N + TN - 1) / TN, nbt = (B + BT - 1) / BT;
  const int nkc = (K + KCH - 1) / KCH;
  const int tiles = nmt * nnt * nbt;
  const int mine = tiles > static_cast<int>(blockIdx.x)
                       ? (tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const int nitems = mine * nkc;
  // w's strides along the kept and the summed channel
  const size_t sn = CONJ ? static_cast<size_t>(K) * M : static_cast<size_t>(M);
  const size_t sk = CONJ ? static_cast<size_t>(M) : static_cast<size_t>(N) * M;

  // the k-th tile of this block: its first mode, kept channel and batch row;
  // channel tiles fastest, so the blocks in flight share d in L2
  auto tile_of = [&](int k, int& m0, int& n0, int& b0) {
    const int t = blockIdx.x + k * gridDim.x;
    n0 = (t % nnt) * TN;
    m0 = ((t / nnt) % nmt) * TMD;
    b0 = (t / (nnt * nmt)) * BT;
  };
  // the copy cursor: the tile and summed channel the next stage() brings,
  // with this thread's units of the weight and d rows at summed channel 0
  int ck = 0, ck0 = 0, cm0 = 0;
  size_t cwb = 0, cdb = 0;
  bool cwok = false, cdok = false;
  auto set_cursor = [&] {
    int n0, b0;
    tile_of(ck, cm0, n0, b0);
    const int mw = cm0 + 4 * cu, md = cm0 + R::UE * du;
    cwok = mw < M && n0 + r4 < N;
    cdok = md < M && b0 + dq < B;
    cwb = static_cast<size_t>(n0 + r4) * sn + mw;
    cdb = static_cast<size_t>(b0 + dq) * K * M + md;
  };
  // this thread's units of ring slot `slot`: weight unit j = HJ p + h is
  // plane p at summed channel kb + 2 h, d unit j = HD p + h at dk + KS h
  auto wdst = [&](int slot, int j) {
    return reinterpret_cast<float*>(stream_smem + slot * R::STAGE) + (j / HJ) * W_PLANE +
           ((kb + 2 * (j % HJ)) * TN + r4) * WP + 4 * cu;
  };
  auto doff = [&](int j) {
    return (j / HD) * D_PLANE + ((dk + R::KS * (j % HD)) * BT + dq) * TMD + R::UE * du;
  };
  auto ddst = [&](int slot, int j) {
    return reinterpret_cast<T*>(stream_smem + slot * R::STAGE + R::W_BYTES) + doff(j);
  };
  // the f32 d that item q (in `slot`) is summed from
  auto dsum = [&](int slot, int q) {
    if constexpr (R::WIDEN) {
      return reinterpret_cast<float*>(stream_smem + STAGES * R::STAGE) + (q & 1) * 2 * D_PLANE;
    } else {
      return reinterpret_cast<float*>(stream_smem + slot * R::STAGE + R::W_BYTES);
    }
  };

  // item q (the cursor's): summed channels ck0.. of its tile into slot q % STAGES
  auto stage = [&](int q) {
    if (q >= nitems) return;
    const int slot = q % STAGES;
#pragma unroll
    for (int j = 0; j < KCH; ++j) {
      const int k = ck0 + kb + 2 * (j % HJ);
      const bool okw = cwok && k < K;
      const float* sw = (j / HJ ? wi : wr) + (okw ? cwb + k * sk : 0);
      float* dw = wdst(slot, j);
      const int kd = ck0 + dk + R::KS * (j % HD);
      const bool okd = cdok && kd < K;
      const T* sd = (j / HD ? di : dr) + (okd ? cdb + static_cast<size_t>(kd) * M : 0);
      T* dd = ddst(slot, j);
      // an f32 d's units are the weight's (4 modes): both go one way
      if (vec) {
        cp_async16(smem_addr(dw), sw, okw ? 16 : 0);
        if constexpr (!R::WIDEN) cp_async16(smem_addr(dd), sd, okd ? 16 : 0);
      } else {
        const int m = cm0 + 4 * cu;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dw[e] = okw && m + e < M ? round_to<CAST>(sw[e]) : 0.f;
          if constexpr (!R::WIDEN) dd[e] = okd && m + e < M ? round_to<CAST>(sd[e]) : 0.f;
        }
      }
      // a half d's, its own way, unrounded
      if constexpr (R::WIDEN) {
        if (j >= R::DJ) continue;
        if (vecd) {
          cp_async16(smem_addr(dd), sd, okd ? 16 : 0);
        } else {
          const int m = cm0 + R::UE * du;
#pragma unroll
          for (int e = 0; e < R::UE; ++e) dd[e] = okd && m + e < M ? sd[e] : Fmt<D>::st(0.f);
        }
      }
    }
    ck0 += KCH;
    if (ck0 >= K) {
      ck0 = 0;
      ++ck;
      if (ck < mine) set_cursor();
    }
  };
  // once item q has landed in `slot`: round, in place, the units this thread
  // copied (those staged element by element were rounded as they were
  // stored), or widen its units of a half d into item q's f32 planes
  auto round4 = [](float* p) {
    const float4 v = *reinterpret_cast<float4*>(p);
    const float2 a = round2<CAST>(v.x, v.y), b = round2<CAST>(v.z, v.w);
    *reinterpret_cast<float4*>(p) = make_float4(a.x, a.y, b.x, b.y);
  };
  auto land = [&](int slot, int q) {
    if constexpr (!R::WIDEN) {
      if (!vec) return;
#pragma unroll
      for (int j = 0; j < KCH; ++j) {
        round4(wdst(slot, j));
        round4(ddst(slot, j));
      }
    } else {
      // a half d needs rounding only onto the other half format
      constexpr bool ROUND_D = ROUND && D != CAST;
#pragma unroll
      for (int j = 0; j < KCH; ++j) {
        if (ROUND && vec) round4(wdst(slot, j));
        if (j >= R::DJ) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(ddst(slot, j));
        const T* h = reinterpret_cast<const T*>(&v);
        float f[R::UE];
#pragma unroll
        for (int e = 0; e < R::UE; e += 2) {
          const float2 v2 = ROUND_D ? round2<CAST>(Fmt<D>::ld(h[e]), Fmt<D>::ld(h[e + 1]))
                                    : make_float2(Fmt<D>::ld(h[e]), Fmt<D>::ld(h[e + 1]));
          f[e] = v2.x;
          f[e + 1] = v2.y;
        }
        // threads du and du + 4 share banks: each starts on the other half
        float* to = dsum(slot, q) + doff(j);
        const bool s4 = du & 4;
        const float4 lo = make_float4(f[0], f[1], f[2], f[3]);
        const float4 hi = make_float4(f[4], f[5], f[6], f[7]);
        *reinterpret_cast<float4*>(to + (s4 ? 4 : 0)) = s4 ? hi : lo;
        *reinterpret_cast<float4*>(to + (s4 ? 0 : 4)) = s4 ? lo : hi;
      }
    }
  };

  if (mine > 0) set_cursor();
#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) {
    stage(q);
    cp_async_commit();
  }

  constexpr int BH = BT / 2;   // batch rows a thread sums
  float accr[BH][4], acci[BH][4];
  for (int q = 0; q < nitems; ++q) {
    cp_async_wait<STAGES - 2>();   // item q has landed
    const int slot = q % STAGES;
    if (ROUND || R::WIDEN) land(slot, q);
    __syncthreads();               // and every thread is done with item q - 1
    stage(q + STAGES - 1);
    cp_async_commit();
    const int kc = q % nkc;
    if (kc == 0) {
#pragma unroll
      for (int b = 0; b < BH; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          accr[b][c] = 0.f;
          acci[b][c] = 0.f;
        }
    }
    const float* swr = reinterpret_cast<const float*>(stream_smem + slot * R::STAGE) + n * WP +
                       4 * mg;
    const float* swi = swr + W_PLANE;
    const float* sdr = dsum(slot, q) + BH * bh * TMD + 4 * mg;
    const float* sdi = sdr + D_PLANE;
#pragma unroll
    for (int k = 0; k < KCH; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(swr + k * TN * WP);
      const float4 c4 = *reinterpret_cast<const float4*>(swi + k * TN * WP);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w}, cw[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int b = 0; b < BH; ++b) {
        const float4 p4 = *reinterpret_cast<const float4*>(sdr + (k * BT + b) * TMD);
        const float4 q4 = *reinterpret_cast<const float4*>(sdi + (k * BT + b) * TMD);
        const float p[4] = {p4.x, p4.y, p4.z, p4.w}, qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          accr[b][c] = fmaf(p[c], a[c], accr[b][c]);
          if constexpr (CONJ) {   // d * conj(w)
            accr[b][c] = fmaf(qv[c], cw[c], accr[b][c]);
            acci[b][c] = fmaf(qv[c], a[c], acci[b][c]);
            acci[b][c] = fmaf(-p[c], cw[c], acci[b][c]);
          } else {                // d * w
            accr[b][c] = fmaf(-qv[c], cw[c], accr[b][c]);
            acci[b][c] = fmaf(p[c], cw[c], acci[b][c]);
            acci[b][c] = fmaf(qv[c], a[c], acci[b][c]);
          }
        }
      }
    }
    if (kc < nkc - 1) continue;

    // the tile is summed: stores along m, straight from registers
    int m0, n0, b0;
    tile_of(q / nkc, m0, n0, b0);
    const int m = m0 + 4 * mg;
    if (n0 + n >= N || m >= M) continue;
#pragma unroll
    for (int b = 0; b < BH; ++b) {
      const int bb = b0 + BH * bh + b;
      if (bb >= B) break;
      const size_t off = (static_cast<size_t>(bb) * N + n0 + n) * M + m;
      if (vec) {
        if constexpr (OUT == FMT_F32) {
          *reinterpret_cast<float4*>(outr + off) =
              make_float4(accr[b][0], accr[b][1], accr[b][2], accr[b][3]);
          *reinterpret_cast<float4*>(outi + off) =
              make_float4(acci[b][0], acci[b][1], acci[b][2], acci[b][3]);
        } else {
          uint2 vr, vi;
          vr.x = pack2<S>(accr[b][0], accr[b][1]);
          vr.y = pack2<S>(accr[b][2], accr[b][3]);
          vi.x = pack2<S>(acci[b][0], acci[b][1]);
          vi.y = pack2<S>(acci[b][2], acci[b][3]);
          *reinterpret_cast<uint2*>(outr + off) = vr;
          *reinterpret_cast<uint2*>(outi + off) = vi;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (m + c < M) {
            outr[off + c] = Fmt<OUT>::st(accr[b][c]);
            outi[off + c] = Fmt<OUT>::st(acci[b][c]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// Launches KERNEL, a __global__ wrapper of contract_stream<CAST, D, OUT, ...>
// whose arguments are contract_stream's, over (B, N, K, M) on `stream`.  Opts
// it in to more than 48 KB of dynamic shared memory, and counts the SMs, once,
// at its first launch (never inside a CUDA graph capture, which follows a
// warm-up).
template <auto KERNEL, int D, int OUT>
int launch_stream(const void* dr, const void* di, const float* wr, const float* wi, void* outr,
                  void* outi, int B, int N, int K, int M, cudaStream_t stream) {
  using T = typename Fmt<D>::T;
  using S = typename Fmt<OUT>::T;
  static const cudaError_t opted =
      cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<T>::SMEM);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (K == 0) {   // an empty sum: zeros, and nothing to read
    const size_t bytes = static_cast<size_t>(B) * N * M * sizeof(S);
    cudaError_t err = cudaMemsetAsync(outr, 0, bytes, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(outi, 0, bytes, stream);
    return static_cast<int>(err);
  }
  // 16-byte copies and 4-mode stores need rows of whole copies and aligned
  // operands; an f32 d's copies are the weight's, so its alignment joins vec
  auto aligned = [](const void* p, size_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; };
  const bool vecd = M % Ring<T>::UE == 0 && aligned(dr, 16) && aligned(di, 16);
  const bool vec = M % 4 == 0 && aligned(wr, 16) && aligned(wi, 16) &&
                   aligned(outr, 4 * sizeof(S)) && aligned(outi, 4 * sizeof(S)) &&
                   (Ring<T>::WIDEN || vecd);
  const long long tiles =
      1LL * ((M + TMD - 1) / TMD) * ((N + TN - 1) / TN) * ((B + BT - 1) / BT);
  const int grid = static_cast<int>(std::min<long long>(tiles, sms));
  KERNEL<<<grid, NT, Ring<T>::SMEM, stream>>>(
      static_cast<const T*>(dr), static_cast<const T*>(di), wr, wi, static_cast<S*>(outr),
      static_cast<S*>(outi), B, N, K, M, vec, vecd);
  return 0;
}

}  // namespace dense_stream

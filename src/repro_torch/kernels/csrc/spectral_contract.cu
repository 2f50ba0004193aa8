// Dense spectral contraction, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dense_fwd_kernel` in
// src/repro/kernels/spectral_contract.py (reached through
// `spectral_contract_pallas`).  For every retained Fourier mode m:
//
//     out[b,o,m] = sum_i x[b,i,m] * w[i,o,m]          (complex)
//
// in split-real form (re = rr - ii, im = ri + ir).  Operands are f32
// (B,I,M) and (I,O,M), M innermost.  CAST rounds each operand onto the
// bf16 or fp16 grid (round to nearest even, as XLA's astype) before use:
// the reference's in-kernel `cast_to`.  Sums are f32.  A product of two
// bf16 or two fp16 values is exact in f32, so f32 FMAs on the rounded
// operands give what tensor cores with f32 accumulation would, up to the
// order of the sum.  The result is stored at OUT (f32, bf16 or fp16).
//
// What bounds it.  At the serving path's shape (B=8, I=O=64, M=1024,
// bf16 out) the kernel must move x 4.2 MB + w 33.6 MB + out 2.1 MB, i.e.
// 11.9 us at 3.35 TB/s, while its 268 MFLOP take 4.0 us on the f32 CUDA
// cores.  It is memory-bound, and the f32 weight read is 84 % of the bytes.
//
// What the design does about it: it streams the weight.  Persistent blocks
// of 256 threads, one an SM, walk (64-mode, 8-output-channel, 8-batch-row)
// tiles; a tile's input channels come ICH at a time through a ring of
// STAGES slots filled by cp.async, 16 bytes a copy: the weight's [ICH][8][64]
// slab and the x slab [ICH][8 rows][64], so two slots of loads (~135 KB an
// SM) are in flight while one is summed, across tiles too, and no barrier
// waits on a load that was issued late.  Each weight element is read from
// device memory once (for B <= 8).  Each thread copies ICH 16-byte units of
// each a slot, from offsets set once a tile, and rounds them onto CAST in
// place once they land (two values a conversion), so every element is
// rounded once.  Thread (o, mg,
// bh) owns output channel o, modes 4 mg.. and batch rows 4 bh..: per input
// channel, two float4 reads of w and eight broadcast float4 reads of x feed
// 64 FMAs, and the sums go out as 16- or 8-byte stores along m.  Every
// output keeps the earlier kernel's order (i ascending from 0, the same two
// FMAs a term), so the result is bit-identical to it.  Batches wider than BT
// run as more tiles and re-read the weights once per BT rows.  Rows off 16
// bytes (M not a multiple of 4, or an operand off its alignment) are staged
// element by element, rounded as they are stored.

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_sync.cuh"

namespace {

using namespace mma_sync;

constexpr int NT = 256;        // threads a block: 16 four-mode groups x 8 outputs x 2
constexpr int TMD = 64;        // modes a tile
constexpr int TO = 8;          // output channels a tile
constexpr int BT = 8;          // batch rows a tile, held in registers
constexpr int ICH = 8;         // input channels a ring slot
constexpr int STAGES = 3;      // ring slots
constexpr int WP = TMD + 4;    // weight rows' pitch (floats): conflict-free float4 reads
constexpr int W_PLANE = ICH * TO * WP;     // floats of a slot's weight, re or im
constexpr int X_PLANE = ICH * BT * TMD;    // floats of a slot's x, re or im
constexpr int STAGE = 2 * (W_PLANE + X_PLANE);
constexpr int SMEM = STAGES * STAGE * 4;   // 198 KB

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

template <int FMT>
struct Store;

template <>
struct Store<FMT_F32> {
  using T = float;
  __device__ static T cvt(float v) { return v; }
};

template <>
struct Store<FMT_BF16> {
  using T = __nv_bfloat16;
  __device__ static T cvt(float v) { return __float2bfloat16_rn(v); }
};

template <>
struct Store<FMT_F16> {
  using T = __half;
  __device__ static T cvt(float v) { return __float2half_rn(v); }
};

template <int CAST, int OUT>
__global__ void __launch_bounds__(NT, 1)
dense_fwd_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 const float* __restrict__ wr, const float* __restrict__ wi,
                 typename Store<OUT>::T* __restrict__ outr,
                 typename Store<OUT>::T* __restrict__ outi,
                 int B, int I, int O, int M, int vec) {
  using S = Store<OUT>;
  constexpr bool ROUND = CAST != FMT_F32;
  constexpr int UPR = TMD / 4;   // 4-mode units a row
  static_assert(NT == 2 * UPR * TO && TO == BT && ICH % 2 == 0,
                "a thread copies ICH units of the weight and ICH of x an item");
  constexpr int HJ = ICH / 2;   // a thread's units in each plane
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  // summing: output channel o, modes 4 mg.., batch rows 4 bh..
  const int o = tid % TO, mg = (tid / TO) % UPR, bh = tid / (TO * UPR);
  // copying: unit cu of row r4 (an output channel of the weight, a batch row
  // of x) of input channels kb, kb + 2, ..., re and im
  const int cu = tid % UPR, r4 = (tid / UPR) % TO, kb = tid / (UPR * TO);
  const int nmt = (M + TMD - 1) / TMD, nto = (O + TO - 1) / TO, nbt = (B + BT - 1) / BT;
  const int nic = (I + ICH - 1) / ICH;
  const int tiles = nmt * nto * nbt;
  const int mine = tiles > static_cast<int>(blockIdx.x)
                       ? (tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const int nitems = mine * nic;
  const size_t OM = static_cast<size_t>(O) * M;

  // the k-th tile of this block: its first mode, output channel and batch
  // row; output tiles fastest, so the blocks in flight share x in L2
  auto tile_of = [&](int k, int& m0, int& o0, int& b0) {
    const int t = blockIdx.x + k * gridDim.x;
    o0 = (t % nto) * TO;
    m0 = ((t / nto) % nmt) * TMD;
    b0 = (t / (nto * nmt)) * BT;
  };
  // the copy cursor: the tile and input channel the next stage() brings,
  // with this thread's unit of the weight and x rows at input channel 0
  int ck = 0, ci0 = 0, cm0 = 0;
  size_t cwb = 0, cxb = 0;
  bool cwok = false, cxok = false;
  auto set_cursor = [&] {
    int o0, b0;
    tile_of(ck, cm0, o0, b0);
    const int m = cm0 + 4 * cu;
    cwok = m < M && o0 + r4 < O;
    cxok = m < M && b0 + r4 < B;
    cwb = static_cast<size_t>(o0 + r4) * M + m;
    cxb = static_cast<size_t>(b0 + r4) * I * M + m;
  };
  // this thread's units of ring slot `slot`: j = HJ p + h is plane p (re,
  // im) at input channel kb + 2 h
  auto wdst = [&](int slot, int j) {
    return smem + slot * STAGE + (j / HJ) * W_PLANE + ((kb + 2 * (j % HJ)) * TO + r4) * WP +
           4 * cu;
  };
  auto xdst = [&](int slot, int j) {
    return smem + slot * STAGE + 2 * W_PLANE + (j / HJ) * X_PLANE +
           ((kb + 2 * (j % HJ)) * BT + r4) * TMD + 4 * cu;
  };

  // item q (the cursor's): input channels ci0.. of its tile into slot q % STAGES
  auto stage = [&](int q) {
    if (q >= nitems) return;
    const int slot = q % STAGES;
#pragma unroll
    for (int j = 0; j < ICH; ++j) {
      const int i = ci0 + kb + 2 * (j % HJ);
      const bool okw = cwok && i < I, okx = cxok && i < I;
      const float* sw = (j / HJ ? wi : wr) + (okw ? cwb + i * OM : 0);
      const float* sx = (j / HJ ? xi : xr) + (okx ? cxb + static_cast<size_t>(i) * M : 0);
      float* dw = wdst(slot, j);
      float* dx = xdst(slot, j);
      if (vec) {
        cp_async16(smem_addr(dw), sw, okw ? 16 : 0);
        cp_async16(smem_addr(dx), sx, okx ? 16 : 0);
      } else {
        const int m = cm0 + 4 * cu;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dw[e] = okw && m + e < M ? round_to<CAST>(sw[e]) : 0.f;
          dx[e] = okx && m + e < M ? round_to<CAST>(sx[e]) : 0.f;
        }
      }
    }
    ci0 += ICH;
    if (ci0 >= I) {
      ci0 = 0;
      ++ck;
      if (ck < mine) set_cursor();
    }
  };
  // round, in place, the units this thread copied into `slot` once they landed
  auto round4 = [](float* d) {
    const float4 v = *reinterpret_cast<float4*>(d);
    const float2 a = round2<CAST>(v.x, v.y), b = round2<CAST>(v.z, v.w);
    *reinterpret_cast<float4*>(d) = make_float4(a.x, a.y, b.x, b.y);
  };
  auto round_slot = [&](int slot) {
#pragma unroll
    for (int j = 0; j < ICH; ++j) {
      round4(wdst(slot, j));
      round4(xdst(slot, j));
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
    if (ROUND && vec) round_slot(slot);
    __syncthreads();               // and every thread is done with item q - 1
    stage(q + STAGES - 1);
    cp_async_commit();
    const int ic = q % nic;
    if (ic == 0) {
#pragma unroll
      for (int b = 0; b < BH; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          accr[b][c] = 0.f;
          acci[b][c] = 0.f;
        }
    }
    const float* swr = smem + slot * STAGE + o * WP + 4 * mg;
    const float* swi = swr + W_PLANE;
    const float* sxr = smem + slot * STAGE + 2 * W_PLANE + BH * bh * TMD + 4 * mg;
    const float* sxi = sxr + X_PLANE;
#pragma unroll
    for (int k = 0; k < ICH; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(swr + k * TO * WP);
      const float4 c4 = *reinterpret_cast<const float4*>(swi + k * TO * WP);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w}, cw[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int b = 0; b < BH; ++b) {
        const float4 p4 = *reinterpret_cast<const float4*>(sxr + (k * BT + b) * TMD);
        const float4 q4 = *reinterpret_cast<const float4*>(sxi + (k * BT + b) * TMD);
        const float p[4] = {p4.x, p4.y, p4.z, p4.w}, qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          accr[b][c] = fmaf(p[c], a[c], accr[b][c]);
          accr[b][c] = fmaf(-qv[c], cw[c], accr[b][c]);
          acci[b][c] = fmaf(p[c], cw[c], acci[b][c]);
          acci[b][c] = fmaf(qv[c], a[c], acci[b][c]);
        }
      }
    }
    if (ic < nic - 1) continue;

    // the tile is summed: stores along m, straight from registers
    int m0, o0, b0;
    tile_of(q / nic, m0, o0, b0);
    const int m = m0 + 4 * mg;
    if (o0 + o >= O || m >= M) continue;
#pragma unroll
    for (int b = 0; b < BH; ++b) {
      const int bb = b0 + BH * bh + b;
      if (bb >= B) break;
      const size_t off = (static_cast<size_t>(bb) * O + o0 + o) * M + m;
      if (vec) {
        if constexpr (OUT == FMT_F32) {
          *reinterpret_cast<float4*>(outr + off) =
              make_float4(accr[b][0], accr[b][1], accr[b][2], accr[b][3]);
          *reinterpret_cast<float4*>(outi + off) =
              make_float4(acci[b][0], acci[b][1], acci[b][2], acci[b][3]);
        } else {
          uint2 vr, vi;
          vr.x = pack2<typename S::T>(accr[b][0], accr[b][1]);
          vr.y = pack2<typename S::T>(accr[b][2], accr[b][3]);
          vi.x = pack2<typename S::T>(acci[b][0], acci[b][1]);
          vi.y = pack2<typename S::T>(acci[b][2], acci[b][3]);
          *reinterpret_cast<uint2*>(outr + off) = vr;
          *reinterpret_cast<uint2*>(outi + off) = vi;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (m + c < M) {
            outr[off + c] = S::cvt(accr[b][c]);
            outi[off + c] = S::cvt(acci[b][c]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int CAST, int OUT>
int launch(const float* xr, const float* xi, const float* wr, const float* wi,
           void* outr, void* outi, int B, int I, int O, int M, cudaStream_t stream) {
  using T = typename Store<OUT>::T;
  // opt in to more than 48 KB of dynamic shared memory, and count the SMs,
  // once, at the first launch (never inside a CUDA graph capture, which
  // follows a warm-up)
  static const cudaError_t opted = cudaFuncSetAttribute(
      dense_fwd_kernel<CAST, OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 4-mode copies and stores need rows of a multiple of 4 modes and aligned operands
  bool vec = M % 4 == 0;
  for (const void* p : {static_cast<const void*>(xr), static_cast<const void*>(xi),
                        static_cast<const void*>(wr), static_cast<const void*>(wi)})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (const void* p : {static_cast<const void*>(outr), static_cast<const void*>(outi)})
    vec = vec && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
  const long long tiles =
      1LL * ((M + TMD - 1) / TMD) * ((O + TO - 1) / TO) * ((B + BT - 1) / BT);
  const int grid = static_cast<int>(std::min<long long>(tiles, sms));
  dense_fwd_kernel<CAST, OUT><<<grid, NT, SMEM, stream>>>(
      xr, xi, wr, wi, static_cast<T*>(outr), static_cast<T*>(outi), B, I, O, M, vec);
  return 0;
}

template <int CAST>
int launch_out(const float* xr, const float* xi, const float* wr,
               const float* wi, void* outr, void* outi, int B, int I, int O,
               int M, int out_fmt, cudaStream_t stream) {
  switch (out_fmt) {
    case FMT_F32:
      return launch<CAST, FMT_F32>(xr, xi, wr, wi, outr, outi, B, I, O, M, stream);
    case FMT_BF16:
      return launch<CAST, FMT_BF16>(xr, xi, wr, wi, outr, outi, B, I, O, M, stream);
    case FMT_F16:
      return launch<CAST, FMT_F16>(xr, xi, wr, wi, outr, outi, B, I, O, M, stream);
  }
  return -1;
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (or -1 for an unknown format
// code; the Python wrapper validates first).
extern "C" int spectral_contract_dense_fwd(
    const void* xr, const void* xi, const void* wr, const void* wi,
    void* outr, void* outi, int B, int I, int O, int M, int cast_fmt,
    int out_fmt, void* stream) {
  const float* a = static_cast<const float*>(xr);
  const float* b = static_cast<const float*>(xi);
  const float* c = static_cast<const float*>(wr);
  const float* d = static_cast<const float*>(wi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  switch (cast_fmt) {
    case FMT_F32:
      rc = launch_out<FMT_F32>(a, b, c, d, outr, outi, B, I, O, M, out_fmt, s);
      break;
    case FMT_BF16:
      rc = launch_out<FMT_BF16>(a, b, c, d, outr, outi, B, I, O, M, out_fmt, s);
      break;
    case FMT_F16:
      rc = launch_out<FMT_F16>(a, b, c, d, outr, outi, B, I, O, M, out_fmt, s);
      break;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

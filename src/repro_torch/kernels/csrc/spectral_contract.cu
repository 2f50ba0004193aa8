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
// What the design does about it.  Each weight element is read from device
// memory once (for B <= 8), by one thread, coalesced along M: a warp
// covers 32 consecutive modes of one (i, o) row.  The x values a block
// needs, for its 32 modes and all of its batch rows, are staged in shared
// memory one chunk of input channels at a time and read back as
// broadcasts.  Each thread owns one (o, m) and keeps BT complex
// accumulators in registers.  A chunk's weights are loaded into registers
// before the x chunk is staged, so IC loads per array are in flight per
// thread.  Batches wider than BT run as more blocks along z and re-read
// the weights once per BT rows.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;  // modes per block: one warp along M
constexpr int TO = 8;   // output channels per block (threadIdx.y)
constexpr int BT = 8;   // batch rows per block, held in registers
constexpr int IC = 16;  // input channels staged per shared-memory pass

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
__global__ void __launch_bounds__(TM * TO)
dense_fwd_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 const float* __restrict__ wr, const float* __restrict__ wi,
                 typename Store<OUT>::T* __restrict__ outr,
                 typename Store<OUT>::T* __restrict__ outi,
                 int B, int I, int O, int M) {
  __shared__ float sxr[IC][BT][TM];
  __shared__ float sxi[IC][BT][TM];

  const int tx = threadIdx.x;
  const int m0 = blockIdx.x * TM;
  const int m = m0 + tx;
  const int o = blockIdx.y * TO + threadIdx.y;
  const int b0 = blockIdx.z * BT;
  const bool live = (m < M) && (o < O);
  const int tid = threadIdx.y * TM + tx;

  float accr[BT], acci[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    accr[b] = 0.f;
    acci[b] = 0.f;
  }

  for (int i0 = 0; i0 < I; i0 += IC) {
    // this thread's weights for the chunk, issued before the x staging so
    // the loads overlap it
    float wrv[IC], wiv[IC];
#pragma unroll
    for (int k = 0; k < IC; ++k) {
      wrv[k] = 0.f;
      wiv[k] = 0.f;
      if (live && i0 + k < I) {
        const size_t off = (static_cast<size_t>(i0 + k) * O + o) * M + m;
        wrv[k] = round_to<CAST>(wr[off]);
        wiv[k] = round_to<CAST>(wi[off]);
      }
    }
    // stage x[b0:b0+BT, i0:i0+IC, m0:m0+TM], zero outside the tensor
    for (int t = tid; t < IC * BT * TM; t += TM * TO) {
      const int mm = t % TM;
      const int bb = (t / TM) % BT;
      const int ii = t / (TM * BT);
      const int gm = m0 + mm, gb = b0 + bb, gi = i0 + ii;
      float vr = 0.f, vi = 0.f;
      if (gm < M && gb < B && gi < I) {
        const size_t off = (static_cast<size_t>(gb) * I + gi) * M + gm;
        vr = round_to<CAST>(xr[off]);
        vi = round_to<CAST>(xi[off]);
      }
      sxr[ii][bb][mm] = vr;
      sxi[ii][bb][mm] = vi;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < IC; ++k) {
      const float a = wrv[k], c = wiv[k];
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float p = sxr[k][b][tx], q = sxi[k][b][tx];
        accr[b] = fmaf(p, a, accr[b]);
        accr[b] = fmaf(-q, c, accr[b]);
        acci[b] = fmaf(p, c, acci[b]);
        acci[b] = fmaf(q, a, acci[b]);
      }
    }
    __syncthreads();
  }

  if (!live) return;
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (b0 + b < B) {
      const size_t off = (static_cast<size_t>(b0 + b) * O + o) * M + m;
      outr[off] = Store<OUT>::cvt(accr[b]);
      outi[off] = Store<OUT>::cvt(acci[b]);
    }
  }
}

template <int CAST, int OUT>
void launch(const float* xr, const float* xi, const float* wr, const float* wi,
            void* outr, void* outi, int B, int I, int O, int M,
            cudaStream_t stream) {
  using T = typename Store<OUT>::T;
  const dim3 block(TM, TO, 1);
  const dim3 grid((M + TM - 1) / TM, (O + TO - 1) / TO, (B + BT - 1) / BT);
  dense_fwd_kernel<CAST, OUT><<<grid, block, 0, stream>>>(
      xr, xi, wr, wi, static_cast<T*>(outr), static_cast<T*>(outi), B, I, O, M);
}

template <int CAST>
int launch_out(const float* xr, const float* xi, const float* wr,
               const float* wi, void* outr, void* outi, int B, int I, int O,
               int M, int out_fmt, cudaStream_t stream) {
  switch (out_fmt) {
    case FMT_F32:
      launch<CAST, FMT_F32>(xr, xi, wr, wi, outr, outi, B, I, O, M, stream);
      return 0;
    case FMT_BF16:
      launch<CAST, FMT_BF16>(xr, xi, wr, wi, outr, outi, B, I, O, M, stream);
      return 0;
    case FMT_F16:
      launch<CAST, FMT_F16>(xr, xi, wr, wi, outr, outi, B, I, O, M, stream);
      return 0;
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

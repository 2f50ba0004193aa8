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
// What the design does about it: it streams the weight through a cp.async
// ring, one persistent block an SM, each element rounded once in place, each
// output's sum order kept.  The design is shared with dense_bwd_x, which sums
// the other channel axis of the same weight: csrc/dense_stream.cuh states
// it.  This source instantiates it with x as the summed data operand.

#include "dense_stream.cuh"

namespace {

using namespace dense_stream;

template <int CAST, int OUT>
__global__ void __launch_bounds__(NT, 1)
dense_fwd_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 const float* __restrict__ wr, const float* __restrict__ wi,
                 typename Fmt<OUT>::T* __restrict__ outr,
                 typename Fmt<OUT>::T* __restrict__ outi,
                 int B, int O, int I, int M, int vec, int vecx) {
  contract_stream<CAST, FMT_F32, OUT, false>(xr, xi, wr, wi, outr, outi, B, O, I, M, vec, vecx);
}

template <int CAST>
int launch_out(const float* xr, const float* xi, const float* wr,
               const float* wi, void* outr, void* outi, int B, int I, int O,
               int M, int out_fmt, cudaStream_t stream) {
  switch (out_fmt) {
    case FMT_F32:
      return launch_stream<&dense_fwd_kernel<CAST, FMT_F32>, FMT_F32, FMT_F32>(
          xr, xi, wr, wi, outr, outi, B, O, I, M, stream);
    case FMT_BF16:
      return launch_stream<&dense_fwd_kernel<CAST, FMT_BF16>, FMT_F32, FMT_BF16>(
          xr, xi, wr, wi, outr, outi, B, O, I, M, stream);
    case FMT_F16:
      return launch_stream<&dense_fwd_kernel<CAST, FMT_F16>, FMT_F32, FMT_F16>(
          xr, xi, wr, wi, outr, outi, B, O, I, M, stream);
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
